"""Plain references the benchmark holds the port against.

Each module is plain PyTorch: it imports neither JAX nor anything of
``repro`` or ``repro_torch``, and it takes nothing the port made.  A
configuration names its reference module (``"reference"`` in its file).
"""
