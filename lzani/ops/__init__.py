"""Device-side ops (JAX/XLA).

The parse tie-break reproduces the reference's double-precision chance-match
comparison (parser.cpp:612-622), so 64-bit types are required.
"""

import jax

jax.config.update("jax_enable_x64", True)
