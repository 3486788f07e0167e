"""The DR coordinator: penalty models, fleet problem, engine, policies."""
