"""PyTorch/CUDA port of the STL-SGD system (``repro``), for NVIDIA Hopper.

Same subpackage layout as the JAX package, so each module's counterpart is
found by name: ``utils``, ``configs``, ``data``, ``comm``, ``engine``,
``core``, ``models``, ``kernels``, ``obs``, ``runtime``, ``serve``,
``launch``. The port imports torch, numpy
and the standard library only — never JAX, never the JAX package.
Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""
