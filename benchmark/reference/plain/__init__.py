"""A frozen copy of the port's plain-torch versions, the benchmark's
reference.

The modules are the port's own plain versions (the twins its kernels are
tested against) as they stood when the benchmark was written, copied with
their CUDA routes taken out: every walk, shading, next-event and primitive
entry point here runs its plain version on whatever device its tensors are
on.  Later changes to the port do not reach this copy, so the benchmark
keeps judging the port against the same arithmetic.  Docstrings that name
kernels describe what the port launches in their place.  Nothing here
imports the port, ``jax`` or the JAX package.
"""
