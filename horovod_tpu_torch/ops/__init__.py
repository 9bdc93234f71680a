"""Collectives (``collective_ops``) and the hand-written CUDA kernels
(``flash_attention``, built by ``_build``)."""
