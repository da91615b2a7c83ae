"""encodec_pytorch_tpu_torch — the PyTorch/CUDA port of encodec_pytorch_tpu.

This package runs the EnCodec codec paths (the causal 24 kHz mono model and
the segmented, normalized 48 kHz stereo model: SEANet encoder, LSTM
bottleneck, residual vector quantizer, packed ``.ecdc`` bitstream, LM
entropy coding), their GAN training step (``train/``, ``train_cli.py``; on
CSVs of wavs or on multi-channel scene recordings, ``data/``), streaming,
serving and objective metrics (``metrics.py``, ``cal_metrics.py``) in
PyTorch, with hand-written CUDA kernels for the hot
loops the JAX package ran as Pallas kernels: the RVQ nearest-code cascade
(``ops/rvq_kernel.py``), the LSTM recurrence (``ops/lstm_kernel.py``), the
fused SEANet resblock (``ops/resblock_kernel.py``), the discriminator's
32-channel convolutions, forward and input gradient
(``ops/disc_conv_kernel.py``), and its F-stride-2 convolutions' forward as an
im2col GEMM (``ops/disc_im2col_kernel.py``); and for the LM codec's
on-device range coder, which the JAX package ran as XLA ops in a scan
(``ops/lm_coder_kernel.py``).

Module names follow the JAX package, so every module has an obvious
counterpart there; the JAX package is the numerical reference the port is
tested against. This package imports torch and never jax or flax.

Public layouts match the JAX package: wav ``[B, C, T]``, codes ``[B, K, T]``.
Parameter names follow the reference torch state-dict layout, so a
released-layout ``.th`` loads with ``strict=True``.
"""

__version__ = "0.1.0"
