"""jpgenc_tpu_torch — the PyTorch/CUDA port of jpgenc_tpu for NVIDIA Hopper.

The JAX package `jpgenc_tpu` stays the reference; this package imports
`torch`, never `jax` and nothing of `jpgenc_tpu` (it keeps its own copy of
the numpy host tier: tables, layout, huffman, config, container, native,
ref, utils). The slices that are in: the batched baseline encode of RGB
4:2:0/4:2:2/4:4:4 and of gray in every mode of the reference's `encode`
(standard tables or two-pass optimized Huffman, any restart interval, frames
of any width, dct_method "float" or the libjpeg-exact "islow"); and the
decoder, from any baseline JFIF file (restart intervals included) to pixels
on the device:

    jpgenc_tpu_torch.parallel.mesh.encode_batch(imgs, quality=75, device="cuda")
    jpgenc_tpu_torch.api.encode(img, quality=75, optimize=True, device="cuda")
    jpgenc_tpu_torch.api.encode(img, restart_interval=120, dct_method="islow")
    jpgenc_tpu_torch.api.decode_batch(files, to_device=True, device="cuda")
    jpgenc_tpu_torch.api.decode(data, device="cuda")

The encoders return the same JFIF bytes as `jpgenc_tpu.api.encode`; the
decoders return `jpgenc_tpu.api.decode`'s pixels up to float rounding on a
knife edge (|diff| <= 1 on fewer than 1e-3 of the bytes). The device is
explicit: "cuda" runs the hand-written kernels under `csrc/` and raises if
CUDA is absent; "cpu" runs each kernel's plain PyTorch version.

The reference runs its transform matmuls at `Precision.HIGHEST`
(jpgenc_tpu/ops/pallas/k1a_fused.py:69-70), so TF32 is switched off for
every float32 matmul and convolution this package (or its plain versions)
issues.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.4.0"
