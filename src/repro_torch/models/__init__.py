"""The port of the JAX package's model substrate (`repro/models`), for
the dense and SSM decoder paths: norms, rotary embeddings, SwiGLU, GQA
attention, Mamba-2 (SSD) blocks and the transformer's forward, cache and
decode step."""
