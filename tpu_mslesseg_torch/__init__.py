"""PyTorch/CUDA port of ``tpu_mslesseg`` for NVIDIA Hopper (H100).

The JAX package ``tpu_mslesseg`` stays the reference; this package mirrors
its tree (``core/``, ``preproc/``, ``model/``, ``infer/``, ``evalx/``) and
its names, so each module has an obvious counterpart. It imports ``torch``
and never ``jax``.

Covered so far: the fused 3-plane consensus serving path
(``infer.consensus3.ConsensusPredictor``) with the proto-mask union as a
hand-written CUDA kernel (``csrc/mask_union.cu``), built on first use by
``_build``.
"""
