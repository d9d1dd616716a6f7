"""The benchmark's plain reference: what a cell's timed path must produce,
worked out again from the cell's inputs (the scene parameters, the
cameras, the seed) with plain PyTorch and NumPy.

``plain/`` is a frozen copy of the port's plain versions; ``scenes.py``
builds each configuration's scene from its grid; ``paths.py`` gives the
framebuffer values of a progressive view at chosen pixels, the preview's
u8 pixels, and the training steps.  Nothing here imports the port,
``jax`` or the JAX package.
"""
