"""The port's drivers (`repro/launch`): batched serving."""
