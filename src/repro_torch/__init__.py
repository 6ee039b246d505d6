"""PyTorch + CUDA port of the LUT-Q system in ``repro`` (JAX + Pallas).

Same subpackage and function names as ``repro``; the JAX package stays
the reference every part of the port is checked against. Entry points
run on CUDA unless the caller asks for ``device="cpu"``.
"""
