"""The port of the JAX package's model substrate (`repro/models`), for
the dense decoder path: norms, rotary embeddings, SwiGLU, GQA attention
and the transformer's forward, cache and decode step."""
