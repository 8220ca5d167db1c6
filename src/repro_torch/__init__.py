"""PyTorch/CUDA port of the OSMOSIS reproduction.

The package mirrors ``repro``'s module names and imports only torch,
numpy and the standard library.  Its entry points run on the card
(``device="cuda"``) unless the caller asks for ``device="cpu"``; without
a card they raise.  Kernels are CUDA C++ sources under
``kernels/csrc``, built with nvcc at first use.
"""
