"""The port's training runtime (`repro/runtime`): checkpoints and the
fault-tolerant runner."""
