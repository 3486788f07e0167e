"""The port's data pipeline (`repro/data`)."""
