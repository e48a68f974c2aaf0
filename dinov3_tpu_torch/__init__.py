"""DINOv3 in PyTorch for NVIDIA Hopper, ported from the JAX package.

``dinov3_tpu`` (JAX) is the reference; this package mirrors its layout
(``configs/``, ``ops/``, ``models/``, ``serve/``, ``interop/``) so each
module's counterpart sits at the same path. It imports neither JAX nor
anything of ``dinov3_tpu``.

Ported so far: the packed serve path — ``serve.build_serve_engine`` →
``PackedServeEngine`` → ``DinoVisionTransformer.packed_feature_forward`` —
with hand-written Hopper kernels for flash-attention forward
(``ops/flash_attention.py``, ``csrc/flash_fwd.cu``) and LayerNorm forward
(``ops/fused_norm.py``, ``csrc/layernorm.cu``).

Entry points take ``device`` (default ``"cuda"``) and raise when no card
is present unless the caller passes ``device="cpu"``; on CPU tensors every
kernel wrapper runs its plain PyTorch version.
"""
