#!/usr/bin/env python3
"""Drive the PyTorch port's 24 kHz codec path, its streaming and serving path
(in f32, and with int8 weight-only weights), LM entropy coding (with a
seeded LM, then with one it trains, through the one-shot and the streaming
LM coders), the conv norms, its GAN training step (in f32, and in the default set's
bf16 with K4 and K5 in their bf16 forms), the trainer's state (checkpoints,
resume after SIGTERM, the test loop, trained-checkpoint loading, weight-norm
folding), the mono-nq2 training mode on the multi-channel scene dataset with
its evaluation (``cal_metrics``), the 48 kHz stereo family (codec,
CodecServer, training step), gradient accumulation, the non-finite step
guard, data-parallel training, deployed artifacts (``deploy.py``) and
segment-parallel inference once on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--before DIR]

Run it from the root of a checkout: it imports ``encodec_pytorch_tpu_torch``
from beside this file, and needs a CUDA card and ``nvcc``. It never falls back
to the CPU. Phases, in the order they run, each of which fails the run:

1. Build the CUDA kernels from ``encodec_pytorch_tpu_torch/csrc`` with nvcc.
2. K1 and K2 against their plain PyTorch versions on the card, at the main
   path's shapes, with median times by CUDA events (20 runs; 5 for the plain
   LSTM loop, ~0.1 s a call): K1 (RVQ cascade) at M in {750, 12000} rows and
   n_q in {8, 32}, and at the serving path's M 64 (a mux tick) and M 8 (a
   join) at n_q 8, with the squared norms cached as the main path has them;
   codes must be >= 99 % identical, and every row whose codes differ must
   first differ at a near-tie (rule in ``rvq_first_differences``). Each shape
   logs its launch (the cluster size, rows a tile and CTAs) and, beside the
   CUDA-event time of a wrapper call, the call's device time (``device_ms``:
   calls queued behind a sleeping kernel; at the serving shapes the former is
   mostly host).
   K2 (LSTM recurrence) at H = C = 512 from a zero state at (T, B) in
   (750, 1), (750, 16), (750, 32), (150, 32), and with a carried state
   (random h0 and c0) at (T 4, B 16), the mux tick's shape, and (T 750, B 1);
   max |h - h_plain| and |c_T - c_plain| <= 1e-4. Timed at each shape: the
   kernel alone, the port's whole layer (projection by ``torch.matmul``, bias,
   kernel) and one cuDNN ``nn.LSTM`` layer with the same weights and state
   (which projects too); then the share of a step spent staging, in the gate
   dot, in the cell update and at the grid barrier (``clock64`` stamps) at
   T 750, B 1 and 16.
3. The port's CLI, in process, at full ``encodec_24khz`` width with seeded
   random weights written as a released-layout ``.th``: a 10 s, 24 kHz wav to
   ``.ecdc`` at 6 kbps and back to wav. The K1, K2 and K3 launch counters are
   set to 0 just before and must be > 0 just after.
3b. The same seeded model built in bfloat16 (``encodec_model_24khz(...,
   dtype=torch.bfloat16)``) on the 10 s clip at 6 kbps against f32: with the
   checkpoint's codebooks (fitted to the model's own residuals) code agreement
   by stage, the latent's relative error, each stage's residual, and decode
   relative RMS < 0.15 and SNR; with random-normal codebooks (the recipe of
   ``tests/test_bf16.py``) >= 95 % of codes equal and relative RMS < 0.15.
   K1 and K2 launched, K3 not (bf16 blocks take the conv sequence). Then
   the bf16 model through a ``StreamingServer`` (2 slots, 4-hop chunks):
   two streams of 224 hops at once (a batched step must carry both slots),
   codes >= 99 % equal to the offline bf16 encode,
   audio >= 20 dB SNR against the offline bf16 decode, K3 not launched.
4. Checks of that output: header (nc 8, al 240000), length, finite values, the
   file's codes equal the in-process encode, the CLI's wav equals the decode.
   Then the same clip through the plain versions: >= 99 % identical codes and
   a decode SNR >= 20 dB against the kernel path. Real-time factors: the
   compress+decompress round trip at B = 1 and encode->decode at B = 16. A
   24 kbps run exercises n_q = 32.
5. K3 (the fused SEANet resblock) against its plain version (pad, ELU and
   cuDNN's ``F.conv1d`` with TF32 off) at the 8 offline shapes of a 10 s
   encode + decode (B 1: C 32/64/128/256 at T 240000/120000/30000/6000, each
   block with its own seeded weights) and the 4 tick shapes of the mux (B 16:
   T 1280/640/160/32, with a streaming halo), plus non-causal padding at C 32
   and a ragged T: max |d| / max|ref| <= 1e-5, kernel (and its device time)
   and plain ms, bound, the launch (cluster size, columns a tile, units); at
   each tick shape, three streamed chunks with a carried halo bit-equal to
   the offline call.
6. The serving path at full width with the seeded weights of phase 3: a
   ``StreamingServer`` of 16 slots, 4 hops a chunk, 6 kbps, warmed up by one
   short stream; then 16 streams of 224 hops (2.99 s), joining at staggered
   ticks with first chunks of 8 hops. Each stream's codes >= 99 % equal to
   the offline ``encode`` of its clip and its audio >= 20 dB SNR against the
   offline decode. The K1, K2 and K3 counters are set to 0 before and must be
   > 0 after, also counted inside the batched step alone. Aggregate audio
   seconds per second, tick ms, steady chunk latency p50/p99. Then a
   ``CodecServer`` with length buckets takes 8 concurrent round trips of mixed
   lengths: each >= 20 dB SNR against a direct call except in its final hop
   (the reflect model is tail-exact), with coalescing.
6a. int8 weight-only serving on phase 3's seeded model: the int8 twin's
   weight bytes against the fold's (< 0.35, the JAX package's bar) and
   ``torch.cuda.memory_allocated`` after loading each; ``LiveCodec(model,
   weights='int8')`` on 10 s at 6 and 24 kbps, B 1 and 16: codes and decode
   equal, bit for bit, to the f32 path on the dequantized weights
   (``prepare.dequantize_weights``), and (information) the code share and
   decode relative RMS against the raw f32 model. K2's int8 entry at (T 750,
   B 1 and 16) and the carried tick (T 4, B 16), K3's on the twin's 8 blocks
   of a 10 s encode + decode and its 4 encoder blocks at the tick: each
   against its plain version and against the f32 kernel on the dequantized
   weights (max |d| 0 expected), timed by CUDA events and on the device
   beside the f32 kernel, cuDNN (``nn.LSTM``, or the block's sequence) on the
   dequantized weights and the bound with the weights' bytes counted as
   int8. Then phase 6's 16-stream ``StreamingServer`` on the twin: codes
   >= 99 % of the offline int8 encode and the audio within atol 2e-5, rtol
   1e-5 of the offline int8 decode of the stream's own codes (the bar of
   ``tests/test_streaming_server.py``'s int8 test; a code flipped at a
   near-tie between the streamed and the offline latent changes the audio
   far more); and a ``CodecServer`` over the int8 ``LiveCodec``. Over the
   int8 codec, streams and server, K1 and the int8 entries of K2 and K3 are
   launched, and the f32 entries of K2 and K3 never.
6b. LM entropy coding at full width: a seeded full-width LM (n_q 32, card
   1024, dim 200, 8 heads, 5 layers, past_context 262) written as a
   reference-layout ``.th``; a 10 s clip at 6 kbps through ``cli -l`` on each
   route: the on-device coder (the LM step and K6), ``--lm_host`` with the LM
   on the card, ``--lm_backend torch`` (the LM on the CPU). Each route: codes
   equal to the packed stream's, the wav equal to the no-LM run's, K1, K2,
   K3 launched, K6 launched on the on-device route only and the C++ host
   coder (not the Python one) on the others, the header's ``lmv`` naming the
   route and the card (none for the LM on the CPU), a second compress writing the
   same bytes; compress and decompress ms and RTF without the loads; bytes
   against packed. Then the LM's probabilities on the card against the CPU
   (max difference; share of CDF entries and rows that differ); the fused
   encode and decode step loops and the host route's teacher-forced chain
   under ``torch.cuda.set_sync_debug_mode('error')``; K6 at the main path's
   pdfs against its plain version and the C++ coder: bytes and CDFs equal,
   a decode step's time by CUDA events over 750 launches and on the device
   (``device_ms``), the host ms a decode call costs (750 calls queued with
   no sync), the device time of an empty launch of the decode's
   configuration (the latency floor), a 750-step encode call on a fresh
   state and zeroed buffer from a ring (the codec encodes 256 steps a
   call), both plain versions' times, the bound; then the same at 24 kbps'
   K 32 (pdfs from the seeded LM's step on seeded codes): bytes equal to
   the host coder's, the decode exact, a decode step's and a 750-step
   encode's times; the LM step's ms.
6d. Entropy-LM training: ``lm_train_cli`` in process at its defaults (dim
   200, 5 layers, 8 heads, past_context 262, batch 8 x 72000, lr 3e-4) on
   phase 3's seeded ``encodec_24khz`` at 6 kbps (n_q 8) and a CSV of 64
   seeded tone-mixture clips of 3.2 s (``scripts/demo_lm_gain.py``'s
   recipe), the epochs fitted to ~40 s by a probe trainer's steps: bits a
   code at the first and last step (the last below the first), the LM step's
   and the codec encode's median ms (host clock, synchronized), peak memory,
   K1-K3 launched by the encode; the ``.msgpack`` reloads bit-equal.
6e. The trained LM through ``cli -l --lm_checkpoint lm.msgpack`` on a
   held-out 10 s tone clip at 6 kbps, on the on-device route and on
   ``--lm_host``: codes equal to the packed stream's, the wav equal to the
   no-LM run's, the LM stream smaller than packed (bytes, bits a code), K6
   launched on the on-device route.
6f. The streaming LM coder (``StreamingLmEncoder``/``StreamingLmDecoder``)
   with the trained LM on that clip's 750 frames, the bytes delivered in
   seeded bursts: every frame exact, at least one stall, the bytes with the
   flush equal to ``FusedLmCoder.encode``'s; the decoder's buffer (one
   frame's bits at the start) rebased on the card; every call of K6's stall
   mode replayed through its plain version on the same inputs (the same
   symbols, stall decisions and states); push and pull ms (p50, p99) beside
   the 13.33 ms frame period; one host sync a frame under torch's sync debug
   mode (one a ``push_frame``, from the card or from numpy, and one a
   ``pull_frame``, none a ``push_bytes``); a stall-mode call that decodes
   and one that stalls, each on its own copy of the state from a ring (no
   copy in the timing), by CUDA events and on the device, the state copy
   alone, the plain version's time, the bound.
6g. ``FusedLmCoder(kv_cache=False)`` on the card: the 10 s round trip exact,
   encode and decode ms beside the ``kv_cache=True`` coder's.
6h. Seeded full-width 24 kHz models with ``layer_norm`` and ``spectral_norm``
   convs (codebooks fitted as phase 3's), 10 s encoded and decoded at 6 kbps
   through the kernels and their plain versions: codes >= 99 % equal, decode
   >= 20 dB; K1 and K2 launched, K3 launched for ``spectral_norm`` (a weight
   norm: K3 on the materialised weights) and not for ``layer_norm`` (an
   output norm: conv sequences).
6c. A deployed artifact (``deploy.py``) of phase 3's seeded ``encodec_24khz``:
   ``deploy_cli --seconds 10 --bandwidths 6 --weights fold`` with all three
   kinds, exported on the card (seconds, bytes), ``DeployedCodec.load`` onto
   it. Over its encode, decode and roundtrip calls the K1, K2 and K3 counters
   go from 0 to > 0 (the programs hold them as ``encodec::*`` nodes); codes
   identical to ``LiveCodec(weights='fold')``'s, the decode and roundtrip
   within 1e-6 relative norm (and whether bit-equal); a ``CodecServer`` over
   the artifact answers 16 round trips of 10 s, submitted before its worker
   starts (one batch), each within 1e-6 of ``LiveCodec`` on the 16 clips at
   once; roundtrip RTF at B 1 and 16, artifact against ``LiveCodec``.
7. K4 (discriminator conv, 3xTF32 on the tensor cores) against its plain
   version (cuDNN's ``F.conv2d`` and ``conv2d_input``, TF32 off) at the 12
   eligible conv shapes of one discriminator call at the training config
   (B 12, 72000 samples): forward and input gradient within 1e-5 · max|ref|;
   median times by CUDA events, and two bounds a shape: 3 x the operations at
   the TF32 tensor-core peak, and the operations at the f32 CUDA-core peak
   (each no less than the bytes' time).
8. The training path through the port's ``train_cli``, in process, at the full
   width of ``encodec_pytorch_tpu/configs/config.yaml``, pinned to f32
   (``tpu.compute_dtype=float32``; the set's default is bf16): 36 synthetic
   3 s wavs (one epoch = 3 steps of 12 x 72000) and 12 more as the test set
   (the trainer's first test loop), no LR warmup so the discriminator
   trains. K4's forward and dx counters and K2's are set to 0 just before
   and must be > 0 just after; losses finite; the generator, the
   discriminator and the codebooks changed. ms per step and peak memory.
8b. The same in the default set's bf16, with no dtype override: K4's bf16
   forward and dx counters set to 0 before and > 0 after; its step ms, device
   busy, idle share (a profiled kernel step) and peak memory beside phase 8's.
9. One more step from the trained state twice (at the largest n_q whose
   codebooks are initialized), once through the kernels and once with every
   kernel swapped for its plain version: losses within
   1e-3 relative, gradients within 1e-3 and updates within 1e-2 by relative
   norm (a code flipped at an f32 near-tie moves them more than roundoff); in
   bf16 2e-2, 5e-2 and 1e-1. The kernel step runs under ``torch.profiler``.
10. Trainer state, at phase 8's full width and data (f32) with the overrides that
    give the ``my_encodec`` architecture (non-causal, ``time_group_norm``)
    and n_q 8 (so that ``encodec_bw`` at 6 kbps loads the same file):
    ``train_cli`` for 2 epochs of 3 steps, a test loop before and after
    each and an asynchronous save after each: ms per step, each test loop's
    ms and losses, each save's snapshot ms (caller thread), write ms
    (writer thread) and size; ``GT.wav`` and ``Reconstruction.wav`` finite;
    the test loops launch K1, K2 and K4. The same run again, and how far
    its parameters, Adam moments and RVQ buffers are from the first's
    (cuDNN's default algorithms need not be deterministic; reported, not
    checked). Then, with deterministic algorithms: an uncut run, and a run
    that gets a real SIGTERM after step 4 and must exit with 143, leaving an
    ``epoch1_preempt`` file beside the unharmed ``epoch1`` file;
    ``train_cli`` resumes from it and finishes. The resumed state against
    the uncut one: the relative norm of each group's difference (<= 1e-3)
    and whether it is bit-equal. The same cut-and-resume again in bf16
    (``tpu.compute_dtype=bfloat16``). Then ``cli -m my_encodec`` and ``-m
    encodec_bw`` at 6 kbps on a 10 s clip with the epoch-2 file: K1 and K2
    launched, codes 100 % equal to the uncut trainer's generator (with 1 s
    segments for ``encodec_bw``), decode SNR >= 20 dB against its decode.
    Last, the weight-norm fold on phase 3's seeded ``encodec_24khz``: ``cli
    --weights fold`` writes the ``--weights raw`` bytes and launches K3;
    the 16-slot mux tick over the folded and the raw model, in turns (raw,
    fold, fold, raw; 50 ticks each): host ms a tick, p50 and p99.
10b. The reference's second training mode, ``train_cli --config
    config_mono_nq2``, at the yaml's full width (``my_encodec``: causal,
    weight norm, 32 filters, ratios 8 5 4 2, n_q 2; f32; batch 16 x 24000;
    ``train_discriminator`` 0.5) through the multi-channel scene dataset, on
    a synthetic eigenscape-style tree (one 6 s file in each of the 6 train
    folders, 8 files of 2 s in each of the 2 test folders so that the 16
    fixed validation segments are distinct; 32 channels, 48 kHz, 16-bit,
    each channel its own tones and noise). Cut in depth only:
    ``datasets.fixed_length=48`` (3 steps and a 3-batch test loop),
    ``common.max_epoch=1``, ``common.save_interval=1`` and
    ``lr_scheduler.warmup_epoch=0`` (so the coin can fire). Then
    ``--config config_mono_nq2_resume`` from the epoch-1 file trains epoch
    2. Finite losses, which tensorboard path the trainer took (events
    written, or its warning), K4 (forward and dx) and K2 launched; step ms,
    the loader's host ms a batch (16 ranged reads of 32 channels, resample),
    peak memory. Kernels against plain from the resumed state at n_q 2,
    with the discriminator's coin forced true and false, by phase 9's f32
    bars (and, without the coin, the discriminator's update 0 in both).
    Last, the first 16 fixed validation segments encoded and decoded at 1.5
    kbps by the trained model in eval (K1, K2, K3 launched), written as wavs
    and scored by ``cal_metrics --device cuda``: the means of STOI, SI-SNR
    and mel distance (reported; no bar), and ``metrics.mel_distance`` on the
    card within 1e-4 relative of the CPU. Then K4 at this config's shapes
    (B 16, 24000 samples: the 12 eligible convs, forward and dx), as phase 7
    checks and times them.
11. K4 at the 48 kHz training config's shapes (B 32, 48000 stereo samples):
    conv_4's forward (K5 takes conv_1..conv_3's) and the input gradient of
    conv_1..conv_4, as phase 7 checks and times them.
12. K5 (the discriminator's im2col conv, 3xTF32 on the tensor cores) against
    its plain version (the im2col GEMM in torch) and cuDNN's ``F.conv2d``
    (TF32 off) at the 9 F-stride-2 conv shapes of one discriminator call at
    the 48 kHz training config (B 32, 48000 stereo samples): within 1e-5 ·
    max|ref| of both, bit-equal on a repeat, its weight packing bit-equal to
    the plain packing, and the trainable route's dx and dW (K4's dx, cuDNN's
    dW) within 1e-5 of ``F.conv2d``'s autograd. At each shape: median times
    by CUDA events of the wrapper, the kernel alone, the packing, the plain
    version, cuDNN and K4's forward (the in-house yardstick), the call's
    device time (``device_ms``), and two bounds (3xTF32, f32).
13. The 48 kHz codec CLI (``-q``), in process, at full ``encodec_48khz`` width
    with seeded weights: a 10 s stereo wav to ``.ecdc`` and back at 6 kbps;
    header (``m encodec_48khz``, ``al 480000``, ``nc 4``), 11 frames each with
    its scale, the last one short; the file's codes and scales equal the
    in-process encode; >= 99 % identical codes and a decode SNR >= 20 dB
    against the plain versions; ``encode_segmajor`` against ``encode``
    >= 99 %; the K1 and K2 counters > 0 and K3's 0 (its resblocks use
    ``time_group_norm``); RTF of the round trip at B 1; a 24 kbps run (n_q 16).
14. A ``CodecServer`` on the 48 kHz model: 8 concurrent stereo round trips of
    1.5, 3, 6 and 10 s (two each), each >= 20 dB SNR against a direct call,
    coalesced into fewer than 8 batches.
14b. A 3 s 48 kHz stereo clip at 6 kbps through ``cli -q -l`` with a seeded
    full-width LM (n_q 16, past_context 525): the on-device coder's
    length-prefixed frames (4: three of 1 s and a short one), their codes
    equal to the encode's, the wav equal to the no-LM run's, K1, K2 and K6
    launched. Then K6 at these shapes (K 4): each frame coded again with
    ``plain_path()`` (K6's plain version) gives the CLI's bytes, and frame 0
    decoded a step a launch by K6 and by its plain version, on the same
    pdfs on the card, gives the same symbols and coder state at every step.
14c. The same as 6c on phase 13's seeded ``encodec_48khz`` (raw weights:
    ``time_group_norm`` does not fold), 10 s stereo at 6 kbps: 11 ragged
    normalized frames (10 of 150 codes, one of 15) with their scales, K1 and
    K2 counted, K3 counted 0.
14d. Segment-parallel inference (``parallel/segment.py``) on that model and
    a 10 s stereo clip at 6 kbps: ``encode_parallel``/``decode_parallel`` in
    one process (the 10 full segments in one call) against the sequential
    ``model.encode``/``decode``; then 2 ranks on the card over gloo
    (subprocesses of this script, ``--seg-rank``), each coding 5 of the
    segments and gathering the rest: the ranks bit-equal, and against one
    process codes >= 99.9 % identical and the wav within 1e-5 relative norm
    (``SEG_CODES_SHARE``, ``SEG_WAV_REL``, fixed before the first run).
15. The 48 kHz training path through ``train_cli --config config_48k_stereo``
    at full width (B 32 x 48000 stereo, f32; 96 synthetic 1.25 s clips, one
    epoch of 3 steps, no LR warmup): the K5, K4 (forward and dx) and K2
    counters > 0; finite losses; the generator, the discriminator and the
    codebooks changed; ms per step and peak memory; then phase 9's
    kernel-vs-plain step at this config.
16. K4 in bf16 (``disc_conv_forward_bf16``, ``disc_conv_input_grad_bf16``:
    ``wgmma`` m64n32k16 bf16 with both operands in shared memory, a producer
    warpgroup pair laying the window out channels-last, f32 sums, bf16 out,
    the bias added after the rounding) at the shapes of a bf16 discriminator
    call of both configs (24
    kHz: the 12 eligible convs, forward and dx; 48 kHz: conv_4's 3 forwards
    and the 12 dx): against the plain version >= 99 % bit-equal and the conv
    before the bias within 1 bf16 ulp, or 1e-5 of max|ref| where the sum
    nearly cancels; the bias added after the rounding bit-exactly; the weight
    packing bit-equal to the plain one; the same bits on a repeat. Times by
    CUDA events (wrapper, kernel alone) and device time, beside the plain
    version, cuDNN in bf16 (``F.conv2d``, ``conv2d_input``), K4's f32 form and
    the bound at the bf16 peak (989 TFLOP/s). Then the 24 kHz discriminator
    at ``model.filters=64``, whose K4 bf16 weights do not stay in shared
    memory: its 12 eligible convs, forward and dx, by the same bf16 rule,
    timed beside cuDNN in bf16.
17. K5 in bf16 (``disc_im2col_forward_bf16``, ``csrc/disc_im2col_bf16.cu``:
    ``wgmma`` m64n32k16 bf16 with both operands in shared memory, producer
    warps laying the window out channels-last, persistent CTAs) at the 9
    F-stride-2 convs of a bf16 48 kHz discriminator call, the same checks,
    beside cuDNN in bf16, K4's bf16 forward (and whether they agree bit for
    bit) and K5's f32 form; each conv's bound at the bf16 peak labelled by
    what binds it (bytes or operations).
18. One full-width step of ``config_48k_stereo`` in bf16 (32 x 48000 stereo):
    K5 and K4 in bf16 launched, peak memory, then kernels against plain from
    the state after it (the bf16 bars of phase 9).
19. Gradient accumulation: ``config_48k_stereo`` f32, one step's peak memory
    at 2 microbatches against 1. The non-finite guard on the 24 kHz default
    set (bf16, full width, Adam ``capturable``): a NaN batch leaves the whole
    state bit-equal with ``skipped_nonfinite`` 1; the guard's
    copy-and-select alone by CUDA events and its copies' size; guarded
    against unguarded steps; 3 guarded steps under
    ``torch.cuda.set_sync_debug_mode('error')`` (no host sync).
20. Data parallelism (``parallel/mesh.py``). (a) Two ranks on the card over
    gloo (NCCL refuses two ranks on one card; gloo takes CUDA tensors and
    stages each all-reduce through the host), each a subprocess of this
    script (``--dp-rank``), each holding 6 rows of a seeded global batch of
    12 x 72000 of the shipped ``config`` at full width, 3 steps (the k-means
    init of all 32 stages and the dead-code expiry, then two discriminator
    updates) with deterministic algorithms, in the config's bf16 and in
    f32; then one process on the 12 rows, the same steps. The ranks' states
    bit-equal (``assert_replicated`` in each rank, then every tensor); the
    2-rank state against the one process's by group (parameters and
    buffers, Adam, balancer, codebook buffers, stage 0's codebook) within
    ``DP_REL``; codes expired; K4 (bf16, f32) and K2 launched; each rank's ms
    a step and ms in collectives (CUDA events on the step's stream) and the
    one process's. Kernels against plain at a rank's 6 rows (phase 9's bf16
    bars). (b) ``train_cli`` as one rank under torchrun's environment
    (``RANK`` 0, ``WORLD_SIZE`` 1, ``MASTER_ADDR``/``MASTER_PORT`` on
    127.0.0.1) over NCCL for 2 steps, with deterministic algorithms: its
    whole state bit-equal to the same run without a process group (a
    one-rank all-reduce is the identity); ms a step, ms in NCCL collectives.

With ``--before DIR`` (another checkout of the port, e.g. the parent commit
unpacked with ``git archive``), phases 2, 5, 12, 16 and 17 also run that
checkout's K1, K3, K5, K4 bf16 and K5 bf16 on the same inputs: its time
beside the kernel's (K4 bf16 and K5 bf16 in turns, parent, this tree, this
tree, parent, and also on the device; K5 bf16 also the kernel alone), and
whether the codes and outputs are bit-equal to it (K5's f32 outputs must
be; for K4 bf16, the share of bit-equal outputs; K5 bf16's conv before the
bias is held to the parent's by the bf16 rule);
phases 7 and 11 hold K4's f32 outputs bit-equal to that checkout's; phases
6b and 6f time its K6 in turns beside this tree's (parent, this tree, this
tree, parent; events and device time) at the same calls: the decode step,
the host ms a call, the 750-step encode, the K 32 lines and the stall-mode
calls, and hold its decode to the same symbols.

Output: one line per measurement (each phase's start with the seconds since
the script started), then a JSON line with each kernel's numbers (launches:
the 24 and 48 kHz codec CLIs', servers' and LM codec runs', phases 10's
and 10b's and the deployed artifacts' and segment-parallel runs' for K1, K2
and K3; both training paths' and phases 10's and 10b's
for K4; the 48 kHz training
steps' for K5 (and phase 20's data-parallel path's for K1, K2, K3 and K4);
the on-device LM route's at 24 and 48 kHz, the trained LM's on-device
route and the ``kv_cache=False`` coder's for K6, whose ``ms`` is a decode
step's; the streaming decoder's for K6's stall mode (``lm_coder_stream``),
whose ``ms`` is a frame's call; phase 6a's int8 serving path's for the int8 entries of K2 and
K3, whose ``max_abs_err_vs_f32`` is against the f32 kernels; K1's and K2's entries list
every timed shape under ``shapes``, K3's its 8 offline and 4 tick shapes,
K4's the totals of the 24 kHz, 48 kHz and mono-nq2 configs, K5's its 9
shapes; the bf16 forms of K4 and K5, launched on the bf16 training path and the 48 kHz bf16 step, their
shapes), the ``nvidia-smi`` name
and power-limit line, and last ``{"ok": true, "device": {...}}``. Without a card,
or outside a checkout, it exits non-zero and prints no result.
"""

import argparse
import contextlib
import io
import json
import os
import statistics
import struct
import subprocess
import sys
import tempfile
import time
import traceback
import types
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SR = 24_000
SR48 = 48_000
SECONDS = 10
K1_TOL_SHARE = 0.99
K1_NEAR_TIE_REL = 1e-5
K2_TOL = 1e-4
K3_TOL_REL = 1e-5
K4_TOL_REL = 1e-5
K5_TOL_REL = 1e-5
# K4 and K5 against the float64 conv on their phases' inputs, per conv: the
# relative norm of the difference and the mean signed error toward the
# reference's sign over its mean magnitude (below 0: outputs shrunk). Summed
# from zero each k-step, both read at most 2.4e-7 and 4.2e-8 at the three
# configs' shapes; their earlier forms, which summed every product onto the
# running sum, 2.2e-6 to 3.6e-6 and -1.9e-6 to -3.1e-6 at every dx of K4 and
# 2.2e-6 to 5.9e-6 and -3.2e-7 to -4.4e-6 at every forward of K5
# (scripts/probe_torch_disc_conv_accuracy.py, NVIDIA H100 80GB HBM3, 700 W)
F64_NORM_REL = 5e-7
F64_BIAS = 1e-7
SNR_MIN_DB = 20.0
TRAIN_LOSS_REL = 1e-3
TRAIN_GRAD_REL = 1e-3
TRAIN_UPDATE_REL = 1e-2
# the kernel-vs-plain step in bf16: the bars of the port-vs-JAX bf16 step on
# the CPU (losses, gradients), and twice the gradients' for the updates (f32:
# 10x its gradients'; Adam's update moves with the gradient's error)
TRAIN_BF16_LOSS_REL = 2e-2
TRAIN_BF16_GRAD_REL = 5e-2
TRAIN_BF16_UPDATE_REL = 1e-1
# a bf16 kernel against its plain version: this share of the outputs
# bit-equal, and each other one within 1 bf16 ulp or within the f32 rule's
# 1e-5 of max|ref| (the f32 sums of two summation orders may differ by that
# much, which is more than an ulp of a near-cancelling output)
BF16_EQUAL_SHARE = 0.99
BF16_CODES_SHARE = 0.95       # tests/test_bf16.py's gates for a bf16 codec
BF16_DECODE_REL_RMS = 0.15
# NVIDIA's data sheet, H100 SXM: f32 on CUDA cores, TF32 and bf16 on the
# tensor cores (dense), and HBM3
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12


class Failed(Exception):
    pass


START = time.perf_counter()


def log(*args):
    print(*args, flush=True)


def phase(name: str):
    log(f'--- {name} (at {time.perf_counter() - START:.1f} s)')


def check(cond, msg):
    if not cond:
        raise Failed(msg)


def nvidia_smi_line() -> str:
    proc = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True, text=True,
                          timeout=60)
    check(proc.returncode == 0 and proc.stdout.strip(), f'nvidia-smi failed: {proc.stderr}')
    return proc.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, runs=20, warmup=3) -> float:
    """Median milliseconds of ``fn`` on the current stream, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(torch, fn, runs=20, tries=3):
    """Mean device milliseconds of a call of ``fn``: CUDA events around
    ``runs`` calls queued behind a sleeping kernel, so that the card starts
    them only once the host has queued them all and the host's launch cost
    is hidden. It counts every kernel a call launches and the gaps between
    back-to-back launches. None if at each of ``tries`` ever longer sleeps
    the card reached the calls before the host had queued them (a call that
    waits for the card, or a full launch queue). ``torch.profiler`` is not
    used: minutes into a process it drops some of a call's kernels."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    cycles = 50_000_000
    for _ in range(tries):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(runs):
            fn()
        end.record()
        queued = not start.query()
        end.synchronize()
        if queued:
            return start.elapsed_time(end) / runs
        cycles *= 4
    return None


def host_ms(torch, fn, calls: int) -> float:
    """Host milliseconds a call to queue ``calls`` calls (``fn`` makes them
    all), by the host clock with no sync inside: the wrappers' cost."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / calls


class FreshRing:
    """``size`` copies of the tensors a timed call changes in place (a
    coder's state, its bit buffer), so that every call of a timed run starts
    from the same values with no copy inside the timing: :meth:`refresh`
    before each measurement, :meth:`take` in each call (an IndexError past
    the ring)."""

    def __init__(self, size: int, *tensors):
        self.tensors = tensors
        self.rings = [t.unsqueeze(0).repeat(size, *([1] * t.dim())) for t in tensors]
        self.views = [list(r.unbind(0)) for r in self.rings]
        self.i = 0

    def refresh(self):
        for ring, t in zip(self.rings, self.tensors):
            ring.copy_(t.expand_as(ring))
        self.i = 0

    def take(self) -> list:
        out = [v[self.i] for v in self.views]
        self.i += 1
        return out


def timed_turns(torch, calls: dict, runs: int, warmup: int = 3, refresh=None,
                per: int = 1, device_runs=None) -> dict:
    """CUDA-event ms (median of ``runs``) and device ms (``device_ms``) of
    each call of ``calls`` (``'new'``, and ``'before'``: the same call into
    another checkout's kernel), in turns before, new, new, before, each the
    mean of its two turns, over ``per`` launches a call; ``refresh`` before
    each measurement, outside it (``device_runs`` calls queued for the device
    time, ``runs`` by default) → {'ms', 'device_ms', 'before_ms',
    'before_device_ms'}."""
    order = ['before', 'new', 'new', 'before'] if calls.get('before') else ['new']
    events, device = {k: [] for k in order}, {k: [] for k in order}
    for k in order:
        if refresh is not None:
            refresh()
        events[k].append(cuda_ms(torch, calls[k], runs=runs, warmup=warmup) / per)
        if refresh is not None:
            refresh()
        d = device_ms(torch, calls[k], runs=device_runs or runs)
        if d is not None:
            device[k].append(d / per)
    out = {}
    for k in events:
        prefix = '' if k == 'new' else 'before_'
        out[f'{prefix}ms'] = statistics.mean(events[k])
        out[f'{prefix}device_ms'] = statistics.mean(device[k]) if device[k] else None
    return out


def fmt_turns(t: dict, unit: str = 'ms', scale: float = 1.0) -> str:
    """'a unit by CUDA events, b on the device' of a :func:`timed_turns`
    result, with the earlier checkout's beside it when it was timed."""
    def one(prefix):
        dev = t[f'{prefix}device_ms']
        dev = 'not measured' if dev is None else f'{dev * scale:.4f} {unit}'
        return f'{t[f"{prefix}ms"] * scale:.4f} {unit} by CUDA events, {dev} on the device'
    return one('') + (f' (the earlier kernel, --before, in turns: {one("before_")})'
                      if 'before_ms' in t else '')


def json_safe(v):
    """``v`` with every NaN (a total over a time that was not measured) as
    None, so that the printed line is strict JSON."""
    if isinstance(v, dict):
        return {k: json_safe(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [json_safe(x) for x in v]
    return None if isinstance(v, float) and v != v else v


def fmt_ms(v) -> str:
    return 'not measured' if v is None or v != v else f'{v:.4f} ms'


def bound_ms(flops: float, nbytes: float, peak: float = PEAK_F32_FLOPS):
    """(least ms the card could take at the ``peak`` operation rate or the
    memory rate, 'operations' or 'bytes')."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ('operations' if t_ops >= t_bytes else 'bytes')


def _tones(rng, t: np.ndarray) -> np.ndarray:
    out = np.zeros(t.size)
    for _ in range(4):
        f = rng.uniform(80, 4000)
        vib = 1 + 0.01 * np.sin(2 * np.pi * rng.uniform(2, 6) * t)
        out += rng.uniform(0.1, 0.3) * np.sin(2 * np.pi * f * t * vib + rng.uniform(0, 2 * np.pi))
    return out


def make_clip(seed: int, batch: int, seconds: float = SECONDS, sr: int = SR,
              channels: int = 1) -> np.ndarray:
    """``[batch, channels, T]`` f32 audio: a few tones with vibrato plus noise
    (stereo: the right channel mixes the left with tones of its own)."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(round(seconds * sr))) / sr
    out = np.zeros((batch, channels, t.size))
    for b in range(batch):
        out[b, 0] = _tones(rng, t) + 0.03 * rng.standard_normal(t.size)
        if channels == 2:
            out[b, 1] = 0.6 * out[b, 0] + 0.4 * _tones(rng, t)
        out[b] *= 0.5 / np.abs(out[b]).max()
    return out.astype(np.float32)


def rvq_first_differences(torch, x, embed, codes, plain):
    """(rows whose codes differ, those whose first difference is not a near-tie).

    Near-tie rule: at the first stage k where a row's codes differ, score the
    row's plain-path residual against E_k with the plain formula; the
    difference is a near-tie if the plain pick's score exceeds the kernel
    pick's score by at most K1_NEAR_TIE_REL times the plain pick's |score|.
    When the kernel took the runner-up, that is the plain top-2 gap.
    """
    diff = codes != plain
    rows = diff.any(0)
    if not bool(rows.any()):
        return 0, 0
    first = diff.int().argmax(0)
    residual = x.clone()
    esq = torch.sum(torch.square(embed), -1)
    not_tie = 0
    for k in range(embed.shape[0]):
        sel = rows & (first == k)
        if bool(sel.any()):
            s = 2.0 * torch.matmul(residual[sel], embed[k].t()) - esq[k][None, :]
            a = s.gather(1, plain[k, sel].long()[:, None])
            b = s.gather(1, codes[k, sel].long()[:, None])
            not_tie += int(((a - b).abs() > K1_NEAR_TIE_REL * a.abs()).sum())
        residual = residual - embed[k][plain[k].long()]
    return int(rows.sum()), not_tie


def k1_phase(torch, rvq_kernel, gen, before=None):
    """K1 against its plain version at the codec's and the serving path's
    shapes, called as the main path calls it (squared norms cached); with
    ``before`` (the kernel modules of an earlier checkout, ``--before``) also
    that kernel's codes and time on the same inputs. Returns the summary at
    (M 750, n_q 8), with every shape under ``shapes``."""
    from encodec_pytorch_tpu_torch.quantization.core_vq import rvq_decode
    D, N = 128, 1024
    summary, shapes = None, []
    # the codec path's shapes (10 s: 750 frames; 16 x 10 s: 12000), and the
    # serving path's: a mux tick (16 slots x 4 frames) and a B = 1 join (8 frames)
    for M, K in ((750, 8), (750, 32), (12000, 8), (12000, 32), (64, 8), (8, 8)):
        x = torch.randn(M, D, generator=gen, device='cuda')
        scale = 0.7 ** torch.arange(K, device='cuda', dtype=torch.float32)
        embed = (torch.randn(K, N, D, generator=gen, device='cuda')
                 * scale[:, None, None]).contiguous()
        esq = rvq_kernel.codebook_sq_norms(embed)
        codes = rvq_kernel.rvq_encode(x, embed, esq)
        plain = rvq_kernel.rvq_encode_reference(x, embed)
        torch.cuda.synchronize()
        same = float((codes == plain).float().mean())
        n_diff, not_tie = rvq_first_differences(torch, x, embed, codes, plain)
        err = float((rvq_decode(embed, codes[:, None]) - rvq_decode(embed, plain[:, None]))
                    .abs().max())
        ms = cuda_ms(torch, lambda: rvq_kernel.rvq_encode(x, embed, esq))
        plain_ms = cuda_ms(torch, lambda: rvq_kernel.rvq_encode_reference(x, embed))
        b_ms, b_by = bound_ms(2.0 * M * N * D * K, 4.0 * (M * D + K * N * D + K * M))
        dev_ms = device_ms(torch, lambda: rvq_kernel.rvq_encode(x, embed, esq))
        cfg = rvq_kernel.launch_config(M, N)
        ctas = -(-M // cfg['rows_per_tile']) * cfg['cluster']
        log(f'K1 rvq_encode M={M} n_q={K} N={N} D={D}: identical codes {same:.6f}, '
            f'rows differing {n_diff}, not near-tie {not_tie}, '
            f'max |dequantized diff| {err:.3e}, kernel {ms:.4f} ms (on the device '
            f'{fmt_ms(dev_ms)}), plain {plain_ms:.4f} ms, '
            f'bound {b_ms:.4f} ms ({b_by}); launch: clusters of {cfg["cluster"]} CTAs, '
            f'{cfg["rows_per_tile"]} rows a tile, {cfg["bins_per_buffer"]} bins a buffer, '
            f'{ctas} CTAs')
        check(same >= K1_TOL_SHARE and not_tie == 0,
              f'K1 disagrees with its plain version at M={M} n_q={K}')
        entry = dict(M=M, n_q=K, ms=ms, device_ms=dev_ms, plain_ms=plain_ms, bound_ms=b_ms,
                     bound_by=b_by, identical=same, max_abs_err=err, cluster=cfg['cluster'],
                     rows_per_tile=cfg['rows_per_tile'])
        if before is not None:
            old = before.rvq_kernel.rvq_encode(x, embed)
            torch.cuda.synchronize()
            old_call = lambda: before.rvq_kernel.rvq_encode(x, embed)
            entry.update(before_ms=cuda_ms(torch, old_call),
                         before_device_ms=device_ms(torch, old_call),
                         equal_to_before=bool(torch.equal(codes, old)))
            log(f'K1 M={M} n_q={K}: the earlier kernel (--before) {entry["before_ms"]:.4f} ms '
                f'(on the device {fmt_ms(entry["before_device_ms"])}), codes bit-equal to it: '
                f'{entry["equal_to_before"]}')
        shapes.append(entry)
        if (M, K) == (750, 8):
            summary = dict(max_abs_err=err, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                           bound_ms=b_ms, bound_by=b_by, library_ms=None)
        else:
            summary['max_abs_err'] = max(summary['max_abs_err'], err)
    summary['shapes'] = shapes
    return summary


def k2_phase(torch, lstm_kernel, gen):
    """K2 against its plain version, and timed like for like against cuDNN:
    at each shape the kernel alone, the port's whole layer (the ``torch.matmul``
    input projection, the bias and K2: what ``ops/lstm.py`` runs) and one
    cuDNN ``nn.LSTM`` layer with the same weights (which also projects).
    Then where a step goes (``lstm_step_profile``) at T 750, B 1 and 16.
    Returns the summary at (T 750, B 1), with every shape under ``shapes``."""
    H = C = 512
    bound = 1 / H ** 0.5
    summary, shapes = None, []
    # offline shapes (zero state): the B 1 codec, the B 16 bulk path, and B 32
    # (the 48 kHz step; segments x requests at T 150); carried states: the
    # mux tick (T 4, B 16) and a long carried run (T 750, B 1)
    for T, B, carried in ((750, 1, False), (750, 16, False), (750, 32, False),
                          (150, 32, False), (4, 16, True), (750, 1, True)):
        x = torch.randn(T, B, C, generator=gen, device='cuda')
        w_ih = (torch.rand(4 * H, C, generator=gen, device='cuda') * 2 - 1) * bound
        w_hh = ((torch.rand(4 * H, H, generator=gen, device='cuda') * 2 - 1) * bound).contiguous()
        bias = (torch.rand(4 * H, generator=gen, device='cuda') * 2 - 1) * bound
        state = ((torch.randn(B, H, generator=gen, device='cuda') * 0.5,
                  torch.randn(B, H, generator=gen, device='cuda')) if carried else (None, None))
        xp = (torch.matmul(x, w_ih.t()) + bias).contiguous()
        h, c = lstm_kernel.lstm_recurrence(xp, w_hh, *state)
        hp, cp = lstm_kernel.lstm_recurrence_reference(xp, w_hh, *state)
        torch.cuda.synchronize()
        err = max(float((h - hp).abs().max()), float((c - cp).abs().max()))

        def layer():    # what ops/lstm.py runs for one layer on the card
            return lstm_kernel.lstm_recurrence(
                (torch.matmul(x, w_ih.t()) + bias).contiguous(), w_hh, *state)

        cudnn = torch.nn.LSTM(C, H).cuda()
        with torch.no_grad():
            cudnn.weight_ih_l0.copy_(w_ih)
            cudnn.weight_hh_l0.copy_(w_hh)
            cudnn.bias_ih_l0.copy_(bias)
            cudnn.bias_hh_l0.zero_()
            hx = None if not carried else (state[0][None].contiguous(), state[1][None].contiguous())
            lib_err = float((cudnn(x, hx)[0] - hp).abs().max())
            library_ms = cuda_ms(torch, lambda: cudnn(x, hx))
        ms = cuda_ms(torch, lambda: lstm_kernel.lstm_recurrence(xp, w_hh, *state))
        layer_ms = cuda_ms(torch, layer)
        plain_ms = cuda_ms(torch, lambda: lstm_kernel.lstm_recurrence_reference(xp, w_hh, *state),
                           runs=5, warmup=1)
        b_ms, b_by = bound_ms(2.0 * T * B * 4 * H * H,
                              4.0 * (T * B * 4 * H + 4 * H * H + T * B * H
                                     + (3 if carried else 1) * B * H))
        kind = 'carried state' if carried else 'zero state'
        log(f'K2 lstm_recurrence {kind} T={T} B={B} H={H}: max |h, c_T - plain| {err:.3e} '
            f'(cuDNN vs plain {lib_err:.3e}); kernel {ms:.4f} ms ({1e3 * ms / T:.3f} us a step), '
            f'layer (projection + bias + kernel) {layer_ms:.4f} ms, cuDNN nn.LSTM layer '
            f'{library_ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})')
        check(np.isfinite(err) and err <= K2_TOL,
              f'K2 disagrees with its plain version at T={T} B={B} ({kind}): {err}')
        shapes.append(dict(T=T, B=B, carried=carried, ms=ms, layer_ms=layer_ms,
                           plain_ms=plain_ms, library_ms=library_ms, bound_ms=b_ms,
                           max_abs_err=err))
        if (T, B, carried) == (750, 1, False):
            summary = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                           bound_by=b_by, library_ms=library_ms)
        summary['max_abs_err'] = max(summary['max_abs_err'], err)
        if T == 750 and B in (1, 16) and not carried:
            p = lstm_kernel.lstm_step_profile(xp, w_hh)
            step_us = 1e3 * ms / T
            log(f'K2 step breakdown T={T} B={B} (clock64 stamps of block 0, shares of '
                f'{p["cycles"]} cycles; us at {step_us:.3f} us a step): '
                + ', '.join(f'{k} {p[k]:.3f} ({p[k] * step_us:.3f} us)'
                            for k in lstm_kernel.STEP_PARTS))
            shapes[-1]['step_shares'] = {k: p[k] for k in lstm_kernel.STEP_PARTS}
    summary['shapes'] = shapes
    return summary


def k3_phase(torch, seed, ckpt: Path, before=None):
    """K3 against its plain version (the cuDNN sequence) at the offline and
    tick shapes, streamed chunks against the offline call at the tick's four
    widths, and with ``before`` (``--before``) the earlier kernel's output and
    time on the same inputs. Returns the summary over the 8 offline blocks,
    with the offline and tick shapes under ``shapes``."""
    from encodec_pytorch_tpu_torch.models.model import encodec_model_24khz
    from encodec_pytorch_tpu_torch.models.seanet import SEANetResnetBlock
    from encodec_pytorch_tpu_torch.ops import resblock_kernel as rk

    model = encodec_model_24khz(checkpoint=ckpt, device='cuda')
    model.set_target_bandwidth(6.)
    calls = []

    def record(module, args):   # the block's input; after a transposed conv, a slice
        calls.append((args[0].detach().contiguous(), module))

    blocks = [m for m in model.modules() if isinstance(m, SEANetResnetBlock)]
    hooks = [b.register_forward_pre_hook(record) for b in blocks]
    with torch.no_grad():
        model(torch.from_numpy(make_clip(seed + 11, batch=1)).cuda())
    for h in hooks:
        h.remove()
    check(len(calls) == 8, f'expected 8 resblock calls, found {len(calls)}')
    gen = torch.Generator(device='cuda').manual_seed(seed + 12)
    cases = [('offline', x, m.fused_weights(), True, None) for x, m in calls]
    for x, m in calls[:4]:   # the encoder's blocks at the tick: 16 slots x 4 hops
        T = 1280 * x.shape[-1] // calls[0][0].shape[-1]
        xt = torch.randn(16, x.shape[1], T, generator=gen, device='cuda') * x.std()
        left = torch.randn(16, x.shape[1], 2, generator=gen, device='cuda') * x.std()
        cases.append(('tick', xt, m.fused_weights(), True, left))
    w32 = calls[0][1].fused_weights()
    x32 = calls[0][0]
    cases += [('non-causal', x32, w32, False, None),
              ('ragged', x32[..., :1001].contiguous(), w32, True, None)]
    tot = {k: 0.0 for k in ('ms', 'device_ms', 'plain_ms', 'bound_ms')}
    if before is not None:
        tot.update(before_ms=0.0, before_device_ms=0.0)
    worst = 0.0
    shapes = []
    for name, x, w, causal, left in cases:
        kw = dict(dilation=1, causal=causal, pad_mode='reflect', left=left)
        got = rk.resblock(x, *w, **kw)
        ref = rk.resblock_reference(x, *w, **kw)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        rel = err / float(ref.abs().max())
        ms = cuda_ms(torch, lambda: rk.resblock(x, *w, **kw))
        plain_ms = cuda_ms(torch, lambda: rk.resblock_reference(x, *w, **kw))
        B, C, T = x.shape
        flops = 6.0 * C * C * B * T
        b_ms, b_by = bound_ms(flops, 4.0 * (2 * B * C * T + sum(t.numel() for t in w)))
        dev_ms = device_ms(torch, lambda: rk.resblock(x, *w, **kw))
        cfg = rk.launch_config(C, w[0].shape[0])
        units = -(-T // cfg['tile']) * B
        log(f'K3 resblock {name} x {tuple(x.shape)}: max |d| {err:.3e} ({rel:.2e} of max), '
            f'kernel {ms:.4f} ms (on the device {fmt_ms(dev_ms)}), plain (pad, ELU, cuDNN '
            f'conv1d x3, add) {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}, '
            f'{flops / 1e9:.3f} GFLOP); launch: clusters of {cfg["cluster"]} CTAs, '
            f'{cfg["tile"]} columns a tile, {units} tiles x rows')
        check(rel <= K3_TOL_REL, f'K3 disagrees with its plain version: {name} {tuple(x.shape)}')
        worst = max(worst, err)
        entry = dict(case=name, shape=list(x.shape), ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                     bound_ms=b_ms, max_abs_err=err, cluster=cfg['cluster'], tile=cfg['tile'])
        if before is not None:
            old = before.resblock_kernel.resblock(x, *w, **kw)
            torch.cuda.synchronize()
            old_call = lambda: before.resblock_kernel.resblock(x, *w, **kw)
            entry.update(before_ms=cuda_ms(torch, old_call),
                         before_device_ms=device_ms(torch, old_call),
                         equal_to_before=bool(torch.equal(got, old)))
            log(f'K3 {name} x {tuple(x.shape)}: the earlier kernel (--before) '
                f'{entry["before_ms"]:.4f} ms (on the device '
                f'{fmt_ms(entry["before_device_ms"])}), output bit-equal to it: '
                f'{entry["equal_to_before"]}')
        if name in ('offline', 'tick'):
            shapes.append(entry)
        if name == 'offline':   # a total is not measured if one of its terms is not
            for k in tot:
                tot[k] = None if tot[k] is None or entry.get(k) is None else tot[k] + entry[k]
        if name == 'tick':   # streamed chunks with a carried halo give the offline bits
            offline = rk.resblock(x, *w, dilation=1, causal=True)
            outs, halo, pos = [], None, 0
            for n in (T // 2 + 3, T // 4, T - T // 2 - 3 - T // 4):
                out, halo = rk.resblock(x[..., pos:pos + n].contiguous(), *w, dilation=1,
                                        causal=True, left=halo, return_carry=True)
                outs.append(out)
                pos += n
            same = bool(torch.equal(torch.cat(outs, -1), offline))
            log(f'K3 streamed chunks at C {C}, T {T}: bit-equal to the offline call: {same}')
            check(same, f'K3 streamed chunks differ from the offline call at C {C}')
    log(f'K3 over the 8 blocks of a 10 s encode + decode: kernel {tot["ms"]:.3f} ms (on the '
        f'device {fmt_ms(tot["device_ms"])}), plain {tot["plain_ms"]:.3f} ms, bound '
        f'{tot["bound_ms"]:.3f} ms'
        + (f', the earlier kernel {tot["before_ms"]:.3f} ms (on the device '
           f'{fmt_ms(tot["before_device_ms"])})' if before is not None else ''))
    return dict(max_abs_err=worst, ms=tot['ms'], device_ms=tot['device_ms'],
                plain_ms=tot['plain_ms'], bound_ms=tot['bound_ms'], bound_by='operations',
                library_ms=tot['plain_ms'], shapes=shapes)


def load_before(path: Path, package: str = 'before_port'):
    """The kernel modules of another checkout of the port (``--before``),
    imported as the package ``package`` beside this one; its kernels build
    into that checkout's own ``build/``."""
    import importlib
    import importlib.util
    pkg = Path(path).resolve() / 'encodec_pytorch_tpu_torch'
    spec = importlib.util.spec_from_file_location(package, pkg / '__init__.py',
                                                  submodule_search_locations=[str(pkg)])
    module = importlib.util.module_from_spec(spec)
    sys.modules[package] = module
    spec.loader.exec_module(module)
    ops = importlib.import_module(f'{package}.ops')
    for name in ('_build', 'rvq_kernel', 'resblock_kernel', 'disc_im2col_kernel',
                 'disc_conv_kernel', 'lm_coder_kernel'):
        importlib.import_module(f'{package}.ops.{name}')
    return ops


@contextlib.contextmanager
def plain_path():
    """Route the port through the kernels' plain versions (for comparison)."""
    from encodec_pytorch_tpu_torch.ops import disc_conv_kernel as dck
    from encodec_pytorch_tpu_torch.ops import lstm_kernel, resblock_kernel, rvq_kernel
    from encodec_pytorch_tpu_torch.ops import disc_im2col_kernel as k5
    from encodec_pytorch_tpu_torch.ops import lm_coder_kernel as k6
    swaps = [(lstm_kernel, 'lstm_recurrence', lstm_kernel.lstm_recurrence_reference),
             (resblock_kernel, 'resblock', resblock_kernel.resblock_reference),
             (lstm_kernel, 'lstm_recurrence_int8', lstm_kernel.lstm_recurrence_int8_reference),
             (resblock_kernel, 'resblock_int8', resblock_kernel.resblock_int8_reference),
             (rvq_kernel, 'rvq_encode',
              lambda x, embed, esq=None: rvq_kernel.rvq_encode_reference(x, embed)),
             (dck, 'disc_conv_forward', dck.disc_conv_forward_reference),
             (dck, 'disc_conv_input_grad', dck.disc_conv_input_grad_reference),
             (k5, 'disc_im2col_forward', k5.disc_im2col_forward_plain),
             (k6, 'lm_coder', k6.lm_coder_reference)]
    saved = [getattr(mod, name) for mod, name, _ in swaps]
    for mod, name, plain in swaps:
        setattr(mod, name, plain)
    try:
        yield
    finally:
        for (mod, name, _), fn in zip(swaps, saved):
            setattr(mod, name, fn)


CKPT = 'encodec_24khz_seeded.th'
CKPT48 = 'encodec_48khz_seeded.th'
CODEC_KERNELS = ('rvq_encode', 'lstm_recurrence', 'resblock')
# the entries that take the int8 twin's weights (prepare.quantize_weights)
INT8_KERNELS = ('lstm_recurrence_int8', 'resblock_int8')


def _codec_entries():
    from encodec_pytorch_tpu_torch.ops import lstm_kernel, resblock_kernel, rvq_kernel
    return {'rvq_encode': rvq_kernel.rvq_encode, 'lstm_recurrence': lstm_kernel.lstm_recurrence,
            'resblock': resblock_kernel.resblock,
            'lstm_recurrence_int8': lstm_kernel.lstm_recurrence_int8,
            'resblock_int8': resblock_kernel.resblock_int8}


def reset_counts():
    """Set the codec path's kernel launch counters (the int8 entries' too) to 0."""
    for fn in _codec_entries().values():
        fn.launches = 0


def read_counts(names=CODEC_KERNELS) -> dict:
    entries = _codec_entries()
    return {name: entries[name].launches for name in names}


def write_seeded_checkpoint(torch, seed: int, path: Path, name: str = 'encodec_24khz'):
    """Full-width ``name`` (a port model) with seeded weights and codebooks
    fitted by :func:`fit_codebooks`."""
    from encodec_pytorch_tpu_torch.models.model import MODELS
    model = MODELS[name](device='cuda', generator=torch.Generator().manual_seed(seed))
    fit_codebooks(torch, model, seed)
    torch.save({k: v.cpu() for k, v in model.state_dict().items()}, path)


def fit_codebooks(torch, model, seed: int):
    """Each stage's codebook of ``model`` (on the card) is 1024 latents drawn
    from a separate seeded clip (for a segmented 48 kHz model, eight
    normalized 1 s segments), taken at that stage's residual (plus 5 %
    noise), so codes spread over the codebook."""
    from encodec_pytorch_tpu_torch.ops.rvq_kernel import rvq_encode_reference
    gen = torch.Generator(device='cuda').manual_seed(seed + 1)
    with torch.no_grad():
        if model.segment is None:
            clip = make_clip(seed + 1, batch=2)
        else:
            clip = make_clip(seed + 1, batch=8, seconds=model.segment, sr=model.sample_rate,
                             channels=model.channels)
        frame, _ = model._normalize_frame(torch.from_numpy(clip).cuda())
        z = model.encoder(frame)
        residual = z.transpose(1, 2).reshape(-1, z.shape[1])
        for layer in model.quantizer.vq.layers:
            pick = torch.randint(residual.shape[0], (1024,), generator=gen, device='cuda')
            noise = torch.randn(1024, residual.shape[1], generator=gen, device='cuda')
            embed = residual[pick] + 0.05 * residual.std() * noise
            cb = layer._codebook
            cb.embed.copy_(embed)
            cb.embed_avg.copy_(embed)
            cb.inited.fill_(1.)
            idx = rvq_encode_reference(residual, embed[None])[0]
            residual = residual - embed[idx.long()]


def snr_db(ref, test) -> float:
    noise = float(((test - ref) ** 2).sum())
    return float('inf') if noise == 0 else 10 * np.log10(float((ref ** 2).sum()) / noise)


def main_path_phase(torch, seed, tmp: Path):
    from encodec_pytorch_tpu_torch import cli
    from encodec_pytorch_tpu_torch import compress as C
    from encodec_pytorch_tpu_torch.bitstream.binary import read_ecdc_header
    from encodec_pytorch_tpu_torch.models.model import encodec_model_24khz
    from encodec_pytorch_tpu_torch.ops import lstm_kernel, resblock_kernel, rvq_kernel
    from encodec_pytorch_tpu_torch.utils import read_wav, write_wav

    ckpt = tmp / CKPT
    write_seeded_checkpoint(torch, seed, ckpt)
    wav_in, ecdc, wav_out = tmp / 'in.wav', tmp / 'out.ecdc', tmp / 'out.wav'
    write_wav(wav_in, make_clip(seed, batch=1)[0], SR)
    common = ['-m', 'encodec_24khz', '-c', str(ckpt), '--device', 'cuda', '-f']

    reset_counts()
    t0 = time.perf_counter()
    cli.main([str(wav_in), str(ecdc), '-b', '6', *common])
    cli.main([str(ecdc), str(wav_out), *common])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = read_counts()
    log(f'main path: CLI compress + decompress of {SECONDS} s in {cli_s:.2f} s '
        f'(model loads included); kernel launches {launches}')
    check(all(v > 0 for v in launches.values()),
          f'the main path did not go through every kernel: {launches}')

    data = ecdc.read_bytes()
    fo = io.BytesIO(data)
    meta = read_ecdc_header(fo)
    log(f'main path: .ecdc {len(data)} bytes, header {meta}')
    check(meta['m'] == 'encodec_24khz' and meta['nc'] == 8 and meta['al'] == SR * SECONDS
          and meta['lm'] is False, f'bad header {meta}')
    out, sr = read_wav(wav_out)
    check(sr == SR and out.shape == (1, SR * SECONDS) and np.isfinite(out).all(),
          f'bad output wav {out.shape} at {sr} Hz')

    model = encodec_model_24khz(checkpoint=ckpt, device='cuda')
    model.set_target_bandwidth(6.)
    wav, _ = read_wav(wav_in)
    x = torch.from_numpy(wav[None]).cuda()
    codes = model.encode(x)[0][0]
    file_codes = C._decompress_frame_packed(model, fo, meta['nc'], meta['fr'])
    check(np.array_equal(file_codes, codes[0].cpu().numpy()),
          'the .ecdc codes differ from the in-process encode')
    dec = model.decode([(codes, None)])[0].cpu().numpy()
    check(np.isfinite(dec).all(), 'non-finite decode')
    check(np.abs(out - np.clip(dec, -0.99, 0.99)).max() <= 2 / 32768,
          "the CLI's wav differs from the in-process decode")
    with plain_path():
        codes_p = model.encode(x)[0][0]
        dec_p = model.decode([(codes_p, None)])[0].cpu().numpy()
    same = float((codes == codes_p).float().mean())
    snr = snr_db(dec_p, dec)
    log(f'main path 6 kbps: identical codes kernel vs plain {same:.6f}, '
        f'decode SNR kernel vs plain {snr:.2f} dB, distinct codes used {len(torch.unique(codes))}')
    check(same >= K1_TOL_SHARE and snr >= SNR_MIN_DB, 'kernel path disagrees with plain path')

    def round_trip():
        return C.decompress(model, C.compress(model, wav))

    round_trip()
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        round_trip()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    t1 = statistics.median(times)
    log(f'RTF round trip (compress + decompress, B=1, {SECONDS} s): {SECONDS / t1:.2f} '
        f'(median {t1 * 1000:.1f} ms of 5)')

    x16 = torch.from_numpy(make_clip(seed + 3, batch=16)).cuda()
    model.decode(model.encode(x16))
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y16 = model.decode(model.encode(x16))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    t16 = statistics.median(times)
    check(y16.shape == x16.shape and bool(torch.isfinite(y16).all()), 'bad B=16 output')
    log(f'RTF encode->decode (EncodecModel, B=16, {SECONDS} s each): {16 * SECONDS / t16:.2f} '
        f'(median {t16 * 1000:.1f} ms of 3)')

    model.set_target_bandwidth(24.)
    data24 = C.compress(model, wav)
    meta24 = read_ecdc_header(io.BytesIO(data24))
    out24, _ = C.decompress(model, data24)
    codes24 = model.encode(x)[0][0]
    with plain_path():
        codes24_p = model.encode(x)[0][0]
    same24 = float((codes24 == codes24_p).float().mean())
    log(f'24 kbps: header nc {meta24["nc"]}, {len(data24)} bytes, identical codes kernel vs '
        f'plain {same24:.6f}')
    check(meta24['nc'] == 32 and out24.shape == (1, SR * SECONDS) and np.isfinite(out24).all()
          and same24 >= K1_TOL_SHARE, '24 kbps run failed')
    return launches


STREAMS = 16
CHUNK_HOPS = 4
FIRST_HOPS = 8
STREAM_HOPS = FIRST_HOPS + 54 * CHUNK_HOPS     # 224 hops, 2.99 s


def serve_streams(torch, model, clips: np.ndarray, names=CODEC_KERNELS):
    """Phase 6's streaming run on ``model``: a ``StreamingServer`` of
    ``STREAMS`` slots and ``CHUNK_HOPS`` hops at 6 kbps, warmed up by one short
    stream, then one stream a clip of ``clips``, joining at staggered ticks
    with first chunks of ``FIRST_HOPS`` hops. Returns (each stream's (audio,
    codes), the steady chunks' latencies in s, the wall s, the server's stats,
    the launches of the kernels ``names`` over the run, and those inside the
    batched step alone)."""
    import threading

    from encodec_pytorch_tpu_torch.serve import StreamingServer

    hop = model.encoder.hop_length
    server = StreamingServer(model, max_streams=STREAMS, chunk_hops=CHUNK_HOPS,
                             max_wait_ms=5.0, bandwidth=6., device='cuda')
    first, chunk = FIRST_HOPS * hop, server.chunk_samples
    check(first >= server.min_first_chunk_samples, 'first chunk below the minimum')
    mux_counts = dict.fromkeys(names, 0)
    real_mux = server._mux

    def counted_mux(*args):
        before = read_counts(names)
        out = real_mux(*args)
        for k, v in read_counts(names).items():
            mux_counts[k] += v - before[k]
        return out
    server._mux = counted_mux

    outputs, latencies, errors = [None] * STREAMS, [], []
    lock = threading.Lock()
    with server:   # warm-up, not measured: the first B = 1 join and the first ticks
        with server.open_stream() as stream:
            stream.process(clips[0][:, :first], timeout=120)
            for a in range(first, first + 2 * chunk, chunk):
                stream.process(clips[0][:, a:a + chunk], timeout=120)
    server._stats.update(ticks=0, joins=0, chunks=0)
    server._tick_s.clear()

    def run_stream(i):
        try:
            deadline = time.monotonic() + 120
            while server.stats()['ticks'] < i:     # join at staggered ticks
                check(time.monotonic() < deadline, f'stream {i} never joined')
                time.sleep(0.001)
            with server.open_stream() as stream:
                pieces = [stream.process(clips[i][:, :first], timeout=120, with_codes=True)]
                for a in range(first, clips.shape[-1], chunk):
                    t0 = time.perf_counter()
                    pieces.append(stream.process(clips[i][:, a:a + chunk], timeout=120,
                                                 with_codes=True))
                    with lock:
                        latencies.append(time.perf_counter() - t0)
            outputs[i] = tuple(np.concatenate(p, axis=-1) for p in zip(*pieces))
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append((i, repr(e)))

    reset_counts()
    threads = [threading.Thread(target=run_stream, args=(i,)) for i in range(STREAMS)]
    with server:
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        wall = time.perf_counter() - t0
        stats = server.stats()
    launches = read_counts(names)
    check(not errors and all(o is not None for o in outputs), f'streams failed: {errors}')
    return outputs, sorted(latencies), wall, stats, launches, mux_counts


def serving_phase(torch, seed, ckpt: Path):
    """Phase 6: the StreamingServer at full width, then a CodecServer.
    Returns the kernels' launch counts of the streaming run."""
    import threading

    from encodec_pytorch_tpu_torch.models.model import encodec_model_24khz
    from encodec_pytorch_tpu_torch.serve import CodecServer, LiveCodec

    model = encodec_model_24khz(checkpoint=ckpt, device='cuda')
    model.set_target_bandwidth(6.)
    hop = model.encoder.hop_length
    clips = make_clip(seed + 200, batch=STREAMS, seconds=STREAM_HOPS * hop / SR)
    x = torch.from_numpy(clips).cuda()
    frames = model.encode(x)
    offline_codes = frames[0][0].cpu().numpy()                         # [16, 8, 224]
    offline = model.decode(frames).cpu().numpy()                       # [16, 1, T]

    outputs, lat, wall, stats, launches, mux_counts = serve_streams(torch, model, clips)
    same = float(np.mean([np.mean(o[1] == offline_codes[i]) for i, o in enumerate(outputs)]))
    snrs = [snr_db(offline[i], o[0]) for i, o in enumerate(outputs)]
    audio_s = STREAMS * clips.shape[-1] / SR
    log(f'serving: StreamingServer {STREAMS} slots x {CHUNK_HOPS} hops at 6 kbps, {STREAMS} '
        f'streams of {clips.shape[-1] / SR:.3f} s (first chunk {FIRST_HOPS} hops): {audio_s:.2f} '
        f'audio s in {wall:.3f} s = {audio_s / wall:.2f} audio s/s aggregate; ticks '
        f'{stats["ticks"]}, joins {stats["joins"]}, tick ms p50 {stats["tick_ms_p50"]:.3f} p99 '
        f'{stats["tick_ms_p99"]:.3f}; steady chunk latency ms p50 '
        f'{1e3 * lat[len(lat) // 2]:.3f} p99 {1e3 * lat[min(len(lat) - 1, int(len(lat) * 0.99))]:.3f}')
    log(f'serving: codes equal to offline {same:.6f}; SNR vs offline decode min '
        f'{min(snrs):.2f} dB, median {statistics.median(snrs):.2f} dB; kernel launches '
        f'{launches}, inside the batched step {mux_counts}')
    check(same >= K1_TOL_SHARE and min(snrs) >= SNR_MIN_DB, 'streamed output disagrees with offline')
    check(all(v > 0 for v in launches.values()) and all(v > 0 for v in mux_counts.values()),
          f'the serving path did not go through every kernel: {launches}, mux {mux_counts}')

    codec = LiveCodec(model, device='cuda')
    lengths = [24000, 20000, 31000, 47000, 12000, 39999, 8000, 45000]
    reqs = [make_clip(seed + 300 + i, batch=1, seconds=n / SR)[0] for i, n in enumerate(lengths)]
    direct = [codec.roundtrip(r[None])[0].cpu().numpy() for r in reqs]
    results = [None] * len(reqs)
    with CodecServer(codec, max_batch=8, max_wait_ms=20.0,
                     length_buckets=[24000, 48000]) as cs:
        def call(i):
            results[i] = cs.roundtrip(reqs[i], timeout=120)
        threads = [threading.Thread(target=call, args=(i,)) for i in range(len(reqs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        cstats = cs.stats()
    check(all(r is not None for r in results), 'a CodecServer request did not finish')
    worst_snr, worst_d = float('inf'), 0.0
    for r, d, n in zip(results, direct, lengths):
        check(r.shape == (1, n), f'CodecServer result {r.shape} for {n} samples')
        cut = (-(-n // hop) - 1) * hop
        worst_snr = min(worst_snr, snr_db(d[..., :cut], r[..., :cut]))
        worst_d = max(worst_d, float(np.abs(d[..., :cut] - r[..., :cut]).max()))
    log(f'serving: CodecServer 8 concurrent round trips of mixed lengths, length buckets '
        f'[24000, 48000]: {cstats["batches"]} batches, mean batch {cstats["mean_batch"]:.2f}, '
        f'latency ms p50 {cstats["latency_p50_ms"]:.2f}; vs direct calls but the final hop: '
        f'min SNR {worst_snr:.2f} dB, max |d| {worst_d:.3e}')
    check(worst_snr >= SNR_MIN_DB and cstats['batches'] < len(reqs),
          'CodecServer results disagree with direct calls, or nothing coalesced')
    return launches


INT8_BYTES_SHARE = 0.35      # tests/test_prepare.py's bar: int8 params below this share of f32
STREAM_ATOL, STREAM_RTOL = 2e-5, 1e-5    # tests/test_streaming_server.py's int8 bar


@contextlib.contextmanager
def counting(names, into: dict):
    """Add to ``into`` the launches of the kernels ``names`` inside the block."""
    before = read_counts(names)
    try:
        yield
    finally:
        for k, v in read_counts(names).items():
            into[k] = into.get(k, 0) + v - before[k]


def _timed(torch, fn) -> tuple:
    """(ms of a call by CUDA events, its device ms)."""
    return cuda_ms(torch, fn), device_ms(torch, fn)


def k2_int8_check(torch, gen) -> dict:
    """K2's int8-W_hh entry at the serving shapes (T 750, B 1 and 16 from the
    zero state; the carried tick, T 4, B 16) against its plain version and
    against the f32 entry on the dequantized matrix (the same bits expected),
    timed beside the f32 entry and cuDNN ``nn.LSTM`` on the dequantized
    weights. Returns the summary at (T 750, B 1), every shape under
    ``shapes``."""
    from encodec_pytorch_tpu_torch.ops import lstm_kernel as lk
    from encodec_pytorch_tpu_torch.ops.int8 import dequantize_int8, quantize_int8
    H = C = 512
    bound = 1 / H ** 0.5
    summary, shapes = None, []
    for T, B, carried in ((750, 1, False), (750, 16, False), (4, 16, True)):
        x = torch.randn(T, B, C, generator=gen, device='cuda')
        w_ih, s_ih = quantize_int8((torch.rand(4 * H, C, generator=gen, device='cuda') * 2 - 1)
                                   * bound)
        w_q8, scale = quantize_int8((torch.rand(4 * H, H, generator=gen, device='cuda') * 2 - 1)
                                    * bound)
        w_hh = dequantize_int8(w_q8, scale)
        w_ih = dequantize_int8(w_ih, s_ih)
        bias = (torch.rand(4 * H, generator=gen, device='cuda') * 2 - 1) * bound
        state = ((torch.randn(B, H, generator=gen, device='cuda') * 0.5,
                  torch.randn(B, H, generator=gen, device='cuda')) if carried else (None, None))
        xp = (torch.matmul(x, w_ih.t()) + bias).contiguous()
        h, c = lk.lstm_recurrence_int8(xp, w_q8, scale, *state)
        h32, c32 = lk.lstm_recurrence(xp, w_hh, *state)
        hp, cp = lk.lstm_recurrence_int8_reference(xp, w_q8, scale, *state)
        torch.cuda.synchronize()
        err = max(float((h - hp).abs().max()), float((c - cp).abs().max()))
        err32 = max(float((h - h32).abs().max()), float((c - c32).abs().max()))
        cudnn = torch.nn.LSTM(C, H).cuda()
        with torch.no_grad():
            cudnn.weight_ih_l0.copy_(w_ih)
            cudnn.weight_hh_l0.copy_(w_hh)
            cudnn.bias_ih_l0.copy_(bias)
            cudnn.bias_hh_l0.zero_()
            hx = None if not carried else (state[0][None].contiguous(), state[1][None].contiguous())
            library_ms = cuda_ms(torch, lambda: cudnn(x, hx))
        ms, dev = _timed(torch, lambda: lk.lstm_recurrence_int8(xp, w_q8, scale, *state))
        ms32, dev32 = _timed(torch, lambda: lk.lstm_recurrence(xp, w_hh, *state))
        plain_ms = cuda_ms(torch, lambda: lk.lstm_recurrence_int8_reference(xp, w_q8, scale,
                                                                           *state),
                           runs=5, warmup=1)
        # W_hh read once as int8 with its scales; xp, h and the states in f32
        b_ms, b_by = bound_ms(2.0 * T * B * 4 * H * H,
                              4.0 * (T * B * 4 * H + T * B * H + (3 if carried else 1) * B * H)
                              + 4 * H * H + 4.0 * 4 * H)
        kind = 'carried state' if carried else 'zero state'
        log(f'K2 int8 lstm_recurrence_int8 {kind} T={T} B={B} H={H}: max |h, c_T| vs plain '
            f'{err:.3e}, vs the f32 kernel on the dequantized W_hh {err32:.3e}; int8 {ms:.4f} ms '
            f'(on the device {fmt_ms(dev)}), f32 kernel {ms32:.4f} ms (on the device '
            f'{fmt_ms(dev32)}), cuDNN nn.LSTM layer {library_ms:.4f} ms, plain {plain_ms:.4f} ms, '
            f'bound {b_ms:.4f} ms ({b_by})')
        check(np.isfinite(err) and err <= K2_TOL and err32 == 0,
              f'K2 int8 disagrees at T={T} B={B} ({kind}): plain {err}, f32 kernel {err32}')
        shapes.append(dict(T=T, B=B, carried=carried, ms=ms, device_ms=dev, f32_ms=ms32,
                           f32_device_ms=dev32, plain_ms=plain_ms, library_ms=library_ms,
                           bound_ms=b_ms, max_abs_err=err, max_abs_err_vs_f32=err32))
        if summary is None:
            summary = dict(max_abs_err=err, max_abs_err_vs_f32=err32, ms=ms, device_ms=dev,
                           plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                           library_ms=library_ms)
        summary['max_abs_err'] = max(summary['max_abs_err'], err)
        summary['max_abs_err_vs_f32'] = max(summary['max_abs_err_vs_f32'], err32)
    summary['shapes'] = shapes
    return summary


def k3_int8_check(torch, seed, qmodel) -> dict:
    """K3's int8-weight entry on the int8 twin's 8 blocks at the shapes of a
    10 s encode + decode (B 1), and on its 4 encoder blocks at the tick's (B
    16, with a halo), against its plain version and the f32 entry on the
    dequantized weights (the same bits expected), timed beside the f32 entry
    and the cuDNN sequence on the dequantized weights. Returns the summary
    over the 8 offline blocks, the shapes under ``shapes``."""
    from encodec_pytorch_tpu_torch.models.seanet import SEANetResnetBlock
    from encodec_pytorch_tpu_torch.ops import resblock_kernel as rk
    from encodec_pytorch_tpu_torch.ops.int8 import dequantize_int8

    calls = []
    blocks = [m for m in qmodel.modules() if isinstance(m, SEANetResnetBlock)]
    hooks = [b.register_forward_pre_hook(lambda m, a: calls.append((a[0].contiguous(), m)))
             for b in blocks]
    with torch.no_grad():
        qmodel(torch.from_numpy(make_clip(seed + 11, batch=1)).cuda())
    for h in hooks:
        h.remove()
    check(len(calls) == 8 and all(m.int8 for _, m in calls),
          f'expected 8 int8 resblock calls, found {len(calls)}')
    gen = torch.Generator(device='cuda').manual_seed(seed + 13)
    cases = [('offline', x, m.fused_weights(), None) for x, m in calls]
    for x, m in calls[:4]:   # the encoder's blocks at the tick: 16 slots x 4 hops
        T = 1280 * x.shape[-1] // calls[0][0].shape[-1]
        xt = torch.randn(16, x.shape[1], T, generator=gen, device='cuda') * x.std()
        left = torch.randn(16, x.shape[1], 2, generator=gen, device='cuda') * x.std()
        cases.append(('tick', xt, m.fused_weights(), left))
    tot = dict.fromkeys(('ms', 'device_ms', 'f32_ms', 'f32_device_ms', 'plain_ms', 'library_ms',
                         'bound_ms'), 0.0)
    worst = worst32 = 0.0
    shapes = []
    for name, x, w, left in cases:
        k1, s1, b1, k2, s2, b2, ks, ss, bs = w
        w32 = (dequantize_int8(k1, s1), b1, dequantize_int8(k2, s2), b2, dequantize_int8(ks, ss),
               bs)
        kw = dict(dilation=1, causal=True, pad_mode='reflect', left=left)
        got = rk.resblock_int8(x, *w, **kw)
        ref = rk.resblock_int8_reference(x, *w, **kw)
        f32 = rk.resblock(x, *w32, **kw)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        rel = err / float(ref.abs().max())
        err32 = float((got - f32).abs().max())
        ms, dev = _timed(torch, lambda: rk.resblock_int8(x, *w, **kw))
        ms32, dev32 = _timed(torch, lambda: rk.resblock(x, *w32, **kw))
        plain_ms = cuda_ms(torch, lambda: rk.resblock_int8_reference(x, *w, **kw))
        library_ms = cuda_ms(torch, lambda: rk.resblock_reference(x, *w32, **kw))
        B, C, T = x.shape
        flops = 6.0 * C * C * B * T
        nbytes = (4.0 * 2 * B * C * T + sum(t.numel() for t in (k1, k2, ks))
                  + 4.0 * sum(t.numel() for t in (s1, b1, s2, b2, ss, bs)))
        b_ms, b_by = bound_ms(flops, nbytes)
        log(f'K3 int8 resblock_int8 {name} x {tuple(x.shape)}: max |d| vs plain {err:.3e} '
            f'({rel:.2e} of max), vs the f32 kernel on the dequantized weights {err32:.3e}; '
            f'int8 {ms:.4f} ms (on the device {fmt_ms(dev)}), f32 kernel {ms32:.4f} ms (on the '
            f'device {fmt_ms(dev32)}), plain (dequantize, cuDNN sequence) {plain_ms:.4f} ms, '
            f'cuDNN sequence on the dequantized weights {library_ms:.4f} ms, bound {b_ms:.4f} ms '
            f'({b_by}); TMA (C, H multiples of 16): {C % 16 == 0 and k1.shape[0] % 16 == 0}')
        check(rel <= K3_TOL_REL and err32 == 0,
              f'K3 int8 disagrees: {name} {tuple(x.shape)}: plain {rel}, f32 kernel {err32}')
        worst, worst32 = max(worst, err), max(worst32, err32)
        entry = dict(case=name, shape=list(x.shape), ms=ms, device_ms=dev, f32_ms=ms32,
                     f32_device_ms=dev32, plain_ms=plain_ms, library_ms=library_ms,
                     bound_ms=b_ms, max_abs_err=err, max_abs_err_vs_f32=err32)
        shapes.append(entry)
        if name == 'offline':   # a total is not measured if one of its terms is not
            for k in tot:
                tot[k] = None if tot[k] is None or entry[k] is None else tot[k] + entry[k]
    log(f'K3 int8 over the 8 blocks of a 10 s encode + decode: int8 {fmt_ms(tot["ms"])} (on the '
        f'device {fmt_ms(tot["device_ms"])}), f32 kernel {fmt_ms(tot["f32_ms"])} (on the device '
        f'{fmt_ms(tot["f32_device_ms"])}), plain {fmt_ms(tot["plain_ms"])}, cuDNN sequence '
        f'{fmt_ms(tot["library_ms"])}, bound {fmt_ms(tot["bound_ms"])}')
    return dict(max_abs_err=worst, max_abs_err_vs_f32=worst32, ms=tot['ms'],
                device_ms=tot['device_ms'], plain_ms=tot['plain_ms'], bound_ms=tot['bound_ms'],
                bound_by='operations', library_ms=tot['library_ms'], f32_ms=tot['f32_ms'],
                shapes=shapes)


def int8_phase(torch, seed, ckpt: Path, gen):
    """Phase 6a: int8 weight-only serving on phase 3's seeded model. Returns
    (K2 int8's summary, K3 int8's summary, the int8 path's launches)."""
    import threading

    from encodec_pytorch_tpu_torch import prepare
    from encodec_pytorch_tpu_torch.models.model import encodec_model_24khz
    from encodec_pytorch_tpu_torch.serve import CodecServer, LiveCodec

    names = CODEC_KERNELS + INT8_KERNELS
    model = encodec_model_24khz(checkpoint=ckpt, device='cuda')
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    live_fold = LiveCodec(model, weights='fold', device='cuda')
    fold_mem = torch.cuda.memory_allocated() - base
    live = LiveCodec(model, weights='int8', device='cuda')
    int8_mem = torch.cuda.memory_allocated() - base - fold_mem
    qmodel = live.model
    share = prepare.param_bytes(qmodel) / prepare.param_bytes(live_fold.model)
    log(f'int8: encoder + decoder bytes int8 {prepare.param_bytes(qmodel)} against the fold: '
        f'{prepare.param_bytes(live_fold.model)} ({share:.4f}); torch.cuda.memory_allocated '
        f'after loading the fold +{fold_mem} bytes, the int8 twin +{int8_mem} bytes (each with '
        f'its quantizer)')
    check(share < INT8_BYTES_SHARE, f'int8 weights take {share:.4f} of the bytes of the fold')
    deq = LiveCodec(prepare.dequantize_weights(qmodel), device='cuda')
    raw = LiveCodec(model, device='cuda')

    # the codec: 10 s at 6 and 24 kbps, B 1 and 16, against the f32 path on
    # the dequantized weights (the same codes and bits expected)
    launches = dict.fromkeys(names, 0)
    for bw in (6., 24.):
        for batch in (1, 16):
            x = make_clip(seed + 400 + batch, batch=batch)
            with counting(names, launches):
                codes = live.encode(x, bandwidth=bw)[0]              # [B, K, T']
                dec = live.decode((codes,), bandwidth=bw)
            codes_d = deq.encode(x, bandwidth=bw)[0]
            codes_r = raw.encode(x, bandwidth=bw)[0]
            dec_d = deq.decode((codes,), bandwidth=bw)
            dec_r = raw.decode((codes_r,), bandwidth=bw)
            same = bool(torch.equal(codes, codes_d)) and bool(torch.equal(dec, dec_d))
            share_r = float((codes == codes_r).float().mean())
            rms = float(torch.sqrt(torch.mean((dec - dec_r) ** 2))
                        / torch.sqrt(torch.mean(dec_r ** 2)))
            log(f'int8 LiveCodec {SECONDS} s at {bw:g} kbps, B {batch}: codes {tuple(codes.shape)} '
                f'and decode equal to the f32 path on the dequantized weights: {same}; against '
                f'the raw f32 model (information): codes equal {share_r:.6f}, decode relative '
                f'RMS {rms:.4f}')
            check(same and bool(torch.isfinite(dec).all()),
                  f'the int8 codec differs from the f32 path on its dequantized weights '
                  f'({bw} kbps, B {batch})')

    # kernels at the main path's shapes (not counted)
    k2 = k2_int8_check(torch, gen)
    k3 = k3_int8_check(torch, seed, qmodel)

    # the servers on the int8 twin
    hop = qmodel.encoder.hop_length
    clips = make_clip(seed + 500, batch=STREAMS, seconds=STREAM_HOPS * hop / SR)
    qmodel.set_target_bandwidth(6.)
    x = torch.from_numpy(clips).cuda()
    offline_codes = qmodel.encode(x)[0][0]
    outputs, lat, wall, stats, stream_launches, mux_counts = serve_streams(torch, qmodel, clips,
                                                                           names)
    same = float(np.mean([np.mean(o[1] == offline_codes[i].cpu().numpy())
                          for i, o in enumerate(outputs)]))
    worst, ok = 0.0, True
    for i, (audio, codes) in enumerate(outputs):
        ref = qmodel.decode([(torch.from_numpy(codes).cuda().reshape(1, *codes.shape[-2:]),
                              None)]).cpu().numpy()[0]
        worst = max(worst, float(np.abs(audio - ref).max()))
        ok &= bool(np.allclose(audio, ref, atol=STREAM_ATOL, rtol=STREAM_RTOL))
    audio_s = STREAMS * clips.shape[-1] / SR
    log(f'int8 StreamingServer {STREAMS} slots x {CHUNK_HOPS} hops: {audio_s:.2f} audio s in '
        f'{wall:.3f} s = {audio_s / wall:.2f} audio s/s; tick ms p50 {stats["tick_ms_p50"]:.3f} '
        f'p99 {stats["tick_ms_p99"]:.3f}; codes equal to the offline int8 encode {same:.6f}; '
        f'audio against the offline int8 decode of its own codes: max |d| {worst:.3e} '
        f'(atol {STREAM_ATOL}, rtol {STREAM_RTOL}: {ok}); launches {stream_launches}, inside '
        f'the batched step {mux_counts}')
    check(ok and same >= K1_TOL_SHARE, 'the int8 stream disagrees with the offline int8 model')
    lengths = [24000, 31000, 12000, 47000]
    reqs = [make_clip(seed + 600 + i, batch=1, seconds=n / SR)[0] for i, n in enumerate(lengths)]
    direct = [live.roundtrip(r[None])[0].cpu().numpy() for r in reqs]
    reset_counts()
    results = [None] * len(reqs)
    with CodecServer(live, max_batch=4, max_wait_ms=20.0) as cs:
        def call(i):
            results[i] = cs.roundtrip(reqs[i], timeout=120)
        threads = [threading.Thread(target=call, args=(i,)) for i in range(len(reqs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        cstats = cs.stats()
    server_launches = read_counts(names)
    check(all(r is not None and r.shape == d.shape for r, d in zip(results, direct)),
          'an int8 CodecServer request did not finish')
    snr = min(snr_db(d, r) for d, r in zip(direct, results))
    log(f'int8 CodecServer {len(reqs)} concurrent round trips: {cstats["batches"]} batches, '
        f'min SNR against direct calls {snr:.2f} dB; launches {server_launches}')
    check(snr >= SNR_MIN_DB, 'the int8 CodecServer disagrees with direct calls')
    for k in names:
        launches[k] += stream_launches[k] + server_launches[k]
    log(f'int8 serving path launches (codec, streams, CodecServer): {launches}')
    check(all(launches[k] > 0 for k in ('rvq_encode',) + INT8_KERNELS)
          and launches['lstm_recurrence'] == 0 and launches['resblock'] == 0
          and all(mux_counts[k] > 0 for k in INT8_KERNELS),
          f'the int8 path did not run on the int8 entries of K2 and K3: {launches}, mux '
          f'{mux_counts}')
    return k2, k3, launches


TRAIN_SECONDS = 3
# the training paths: (sample rate, channels, seconds a synthetic clip, seed offset)
TRAIN_DATA = {'config': (SR, 1, TRAIN_SECONDS, 100), 'config_48k_stereo': (SR48, 2, 1.25, 500)}


def train_overrides(tmp: Path, seed: int, config: str = 'config', batches: int = 3) -> list:
    """``batches`` batches of synthetic clips in a CSV (``config``, 3: 36 mono
    clips of 3 s at 24 kHz; ``config_48k_stereo``: 96 stereo clips of 1.25 s
    at 48 kHz, cropped to 1 s), one batch more as the test set, and the overrides of the
    port's default set ``config`` (at its full widths, in its own compute
    dtype) that train one epoch on them (after the test loop the trainer runs
    first), saving under ``tmp``."""
    from encodec_pytorch_tpu_torch.config import load_config
    from encodec_pytorch_tpu_torch.utils import write_wav
    sr, channels, seconds, offset = TRAIN_DATA[config]
    n_clips = batches * int(load_config(name=config).datasets.batch_size)
    paths = []
    for i in range(n_clips):
        paths.append(tmp / f'train_{i}.wav')
        write_wav(paths[-1], make_clip(seed + offset + i, batch=1, seconds=seconds, sr=sr,
                                       channels=channels)[0], sr)
    csv = tmp / 'train.csv'
    csv.write_text(''.join(f'{p}\n' for p in paths))
    n_test = int(load_config(name=config).datasets.batch_size)
    test_paths = [tmp / f'test_{i}.wav' for i in range(n_test)]
    for i, path in enumerate(test_paths):
        write_wav(path, make_clip(seed + offset + 1000 + i, batch=1, seconds=seconds, sr=sr,
                                  channels=channels)[0], sr)
    test_csv = tmp / 'test.csv'
    test_csv.write_text(''.join(f'{p}\n' for p in test_paths))
    return [f'datasets.train_csv_path={csv}', f'datasets.test_csv_path={test_csv}',
            f'checkpoint.save_folder={tmp}/checkpoints/', 'common.max_epoch=1',
            'common.log_interval=1', f'common.seed={seed}', 'lr_scheduler.warmup_epoch=0']


def f64_errors(torch, got, ref) -> tuple:
    """(the relative norm of ``got - ref``, the mean signed error toward
    ``ref``'s sign over its mean magnitude), ``ref`` float64."""
    d = got.double() - ref
    return (float(torch.linalg.vector_norm(d) / torch.linalg.vector_norm(ref)),
            float((d * ref.sign()).mean() / ref.abs().mean()))


def f64_ok(e: tuple) -> bool:
    return e[0] <= F64_NORM_REL and abs(e[1]) <= F64_BIAS


def k4_bounds(flops: float, nbytes: float):
    """K4's two bounds in ms, (3xTF32 on the tensor cores, f32 on the CUDA
    cores), each the larger of its operations' time and the bytes' time."""
    t_bytes = nbytes / PEAK_BYTES
    return (1e3 * max(3 * flops / PEAK_TF32_FLOPS, t_bytes),
            1e3 * max(flops / PEAK_F32_FLOPS, t_bytes))


def k4_phase(torch, seed, config_name: str = 'config', before=None):
    """K4 against cuDNN (TF32 off) at the shapes one discriminator call of the
    training config gives it: every conv K4 takes runs forward and dx, and at
    48 kHz, where K5 takes conv_1..conv_3's forward, those convs run K4's dx
    only. Each output is also held to the float64 conv, by relative norm and
    by its mean signed error (``F64_NORM_REL``, ``F64_BIAS``). With ``before``
    (another checkout), its K4 must give the same bits. Returns the forward
    and dx summaries over the call."""
    import torch.nn.functional as F

    from encodec_pytorch_tpu_torch.config import load_config
    from encodec_pytorch_tpu_torch.ops import disc_conv_kernel as dck

    config = load_config(['tpu.compute_dtype=float32'], name=config_name)
    calls = record_disc_convs(
        torch, config, seed, seed + 7,
        lambda m: getattr(m, 'uses_kernel', False) or getattr(m, 'uses_im2col', False))
    check(len(calls) == 12, f'expected 12 eligible convs, found {len(calls)}')
    gen = torch.Generator(device='cuda').manual_seed(seed + 8)
    keys = ('f_ms', 'f_lib', 'f_bound', 'f_bound32', 'f_kern', 'f_pack',
            'd_ms', 'd_lib', 'd_bound', 'd_bound32', 'd_kern', 'd_pack')
    tot = {k: 0.0 for k in keys}
    err_f = err_d = err64 = bias64 = 0.0
    n_fwd = 0
    for x, w, b, m in calls:
        geo = (m.stride, m.dilation, m.padding)
        y_ref = dck.disc_conv_forward_reference(x, w, b, *geo)
        flops = 2.0 * y_ref.numel() * w.shape[1] * w.shape[2] * w.shape[3]
        line = f'K4 {config_name} x {tuple(x.shape)} w {tuple(w.shape)} stride {m.stride} ' \
               f'dilation {m.dilation}, {flops / 1e9:.2f} GFLOP:'
        if m.uses_kernel:
            n_fwd += 1
            y = dck.disc_conv_forward(x, w, b, *geo)
            torch.cuda.synchronize()
            ef = float((y - y_ref).abs().max())
            rf = ef / float(y_ref.abs().max())
            wk = dck.pack_weight_cuda(w, m.stride[1], dx=False)
            check(torch.equal(wk, dck.pack_weight(w.permute(1, 2, 3, 0)[None])),
                  f'K4 weight packing disagrees with its plain version at w {tuple(w.shape)}')
            f_ms = cuda_ms(torch, lambda: dck.disc_conv_forward(x, w, b, *geo))
            f_kern = cuda_ms(torch, lambda: dck.forward_packed(x, wk, b, w.shape, *geo))
            f_pack = cuda_ms(torch, lambda: dck.pack_weight_cuda(w, m.stride[1], dx=False))
            f_lib = cuda_ms(torch, lambda: dck.disc_conv_forward_reference(x, w, b, *geo))
            f_bounds = k4_bounds(flops, 4.0 * (x.numel() + w.numel() + b.numel() + y.numel()))
            e64 = f64_errors(torch, y, F.conv2d(x.double(), w.double(), b.double(),
                                                stride=m.stride, padding=m.padding,
                                                dilation=m.dilation))
            line += (f' fwd max |d| {ef:.3e} ({rf:.2e} of max), from float64 {e64[0]:.2e} by '
                     f'norm, bias {e64[1]:+.2e}, wrapper {f_ms:.4f} ms (kernel '
                     f'{f_kern:.4f} ms, weight packing {f_pack:.4f} ms), cuDNN {f_lib:.4f} ms, '
                     f'bound {f_bounds[0]:.4f} ms (3xTF32) / {f_bounds[1]:.4f} ms (f32);')
            check(rf <= K4_TOL_REL, f'K4 forward disagrees with cuDNN at x {tuple(x.shape)}: {rf}')
            check(f64_ok(e64), f'K4 forward drifts from float64 at x {tuple(x.shape)}: {e64}')
            err64 = max(err64, e64[0])
            bias64 = max(bias64, abs(e64[1]))
            if before is not None:
                same = torch.equal(y, before.disc_conv_kernel.disc_conv_forward(x, w, b, *geo))
                line += f' bit-equal to the earlier kernel: {same};'
                check(same, f'K4 forward differs from the earlier kernel at x {tuple(x.shape)}')
            err_f = max(err_f, ef)
            for k, v in zip(keys[:6], (f_ms, f_lib, *f_bounds, f_kern, f_pack)):
                tot[k] += v
            del y
        g = torch.randn(y_ref.shape, generator=gen, device='cuda')
        del y_ref
        dx = dck.disc_conv_input_grad(g, w, x.shape, *geo)
        dx_ref = dck.disc_conv_input_grad_reference(g, w, x.shape, *geo)
        torch.cuda.synchronize()
        ed = float((dx - dx_ref).abs().max())
        rd = ed / float(dx_ref.abs().max())
        wk = dck.pack_weight_cuda(w, m.stride[1], dx=True)
        check(torch.equal(wk, dck.pack_weight(dck.pack_dx_weight(w, m.stride[1]))),
              f'K4 dx weight packing disagrees with its plain version at w {tuple(w.shape)}')
        d_ms = cuda_ms(torch, lambda: dck.disc_conv_input_grad(g, w, x.shape, *geo))
        d_kern = cuda_ms(torch, lambda: dck.input_grad_packed(g, wk, w.shape, x.shape, *geo))
        d_pack = cuda_ms(torch, lambda: dck.pack_weight_cuda(w, m.stride[1], dx=True))
        d_lib = cuda_ms(torch, lambda: dck.disc_conv_input_grad_reference(g, w, x.shape, *geo))
        d_bounds = k4_bounds(flops, 4.0 * (g.numel() + w.numel() + dx.numel()))
        e64 = f64_errors(torch, dx, torch.nn.grad.conv2d_input(
            x.shape, w.double(), g.double(), stride=m.stride, padding=m.padding,
            dilation=m.dilation))
        log(f'{line} dx max |d| {ed:.3e} ({rd:.2e} of max), from float64 {e64[0]:.2e} by norm, '
            f'bias {e64[1]:+.2e}, wrapper {d_ms:.4f} ms (kernel '
            f'{d_kern:.4f} ms, weight packing {d_pack:.4f} ms), cuDNN {d_lib:.4f} ms, bound '
            f'{d_bounds[0]:.4f} ms (3xTF32) / {d_bounds[1]:.4f} ms (f32)')
        check(rd <= K4_TOL_REL, f'K4 dx disagrees with cuDNN at x {tuple(x.shape)}: {rd}')
        check(f64_ok(e64), f'K4 dx drifts from float64 at x {tuple(x.shape)}: {e64}')
        err64 = max(err64, e64[0])
        bias64 = max(bias64, abs(e64[1]))
        if before is not None:
            same = torch.equal(dx, before.disc_conv_kernel.disc_conv_input_grad(g, w, x.shape,
                                                                                 *geo))
            log(f'K4 {config_name} x {tuple(x.shape)}: dx bit-equal to the earlier kernel: '
                f'{same}')
            check(same, f'K4 dx differs from the earlier kernel at x {tuple(x.shape)}')
        err_d = max(err_d, ed)
        for k, v in zip(keys[6:], (d_ms, d_lib, *d_bounds, d_kern, d_pack)):
            tot[k] += v
        del dx, dx_ref, g
    log(f'K4 {config_name} over one discriminator call ({n_fwd} forward, {len(calls)} dx): '
        f'forward {tot["f_ms"]:.3f} ms (kernel {tot["f_kern"]:.3f} ms, packing '
        f'{tot["f_pack"]:.3f} ms) vs cuDNN {tot["f_lib"]:.3f} ms (bound {tot["f_bound"]:.3f} ms '
        f'3xTF32, {tot["f_bound32"]:.3f} ms f32); dx {tot["d_ms"]:.3f} ms (kernel '
        f'{tot["d_kern"]:.3f} ms, packing {tot["d_pack"]:.3f} ms) vs cuDNN {tot["d_lib"]:.3f} ms '
        f'(bound {tot["d_bound"]:.3f} ms 3xTF32, {tot["d_bound32"]:.3f} ms f32); from float64 '
        f'at most {err64:.2e} by norm and {bias64:.2e} of bias (bars {F64_NORM_REL:g}, '
        f'{F64_BIAS:g})')
    fwd, dx = ({'max_abs_err': err, 'ms': tot[p + 'ms'], 'plain_ms': tot[p + 'lib'],
                'bound_ms': tot[p + 'bound'], 'bound_by': 'operations',
                'library_ms': tot[p + 'lib'], 'bound_f32_ms': tot[p + 'bound32'],
                'kernel_ms': tot[p + 'kern'], 'packing_ms': tot[p + 'pack']}
               for p, err in (('f_', err_f), ('d_', err_d)))
    return fwd, dx


def k5_phase(torch, seed, before=None):
    """K5 against its plain version (the im2col GEMM) and cuDNN's ``F.conv2d``
    at the 9 F-stride-2 conv shapes of one discriminator call at the 48 kHz
    training config, forward (also against the float64 conv, by relative
    norm and mean signed error) and the trainable route's dx and dW; beside it,
    K4's forward and (with ``before``) the other checkout's K5 on the same
    inputs. Returns the summary over the 9 convs, each shape under
    ``shapes``."""
    import torch.nn.functional as F

    from encodec_pytorch_tpu_torch.config import load_config
    from encodec_pytorch_tpu_torch.ops import disc_conv_kernel as dck
    from encodec_pytorch_tpu_torch.ops import disc_im2col_kernel as k5

    calls = record_disc_convs(torch, load_config(name='config_48k_stereo'), seed, seed + 17,
                              lambda m: getattr(m, 'uses_im2col', False))
    check(len(calls) == 9, f'expected 9 F-stride-2 convs, found {len(calls)}')
    gen = torch.Generator(device='cuda').manual_seed(seed + 18)
    keys = ('ms', 'device_ms', 'kernel_ms', 'packing_ms', 'plain_ms', 'library_ms', 'k4_ms',
            'bound_ms', 'bound_f32_ms', 'gflop') + (('before_ms',) if before is not None else ())
    tot = {k: 0.0 for k in keys}
    worst = worst_grad = worst64 = bias64 = 0.0
    shapes = []
    for x, w, b, m in calls:
        geo = (m.dilation, m.padding)
        y = k5.disc_im2col_forward(x, w, b, *geo)
        y_plain = k5.disc_im2col_forward_plain(x, w, b, *geo)
        y_lib = F.conv2d(x, w, b, stride=k5.STRIDE, padding=m.padding, dilation=m.dilation)
        torch.cuda.synchronize()
        top = float(y_lib.abs().max())
        e_plain = float((y - y_plain).abs().max())
        e_lib = float((y - y_lib).abs().max())
        e64 = f64_errors(torch, y, F.conv2d(x.double(), w.double(), b.double(), stride=k5.STRIDE,
                                            padding=m.padding, dilation=m.dilation))
        del y_plain
        same = bool(torch.equal(y, k5.disc_im2col_forward(x, w, b, *geo)))
        wk = k5.pack_weight_cuda(w)
        check(torch.equal(wk, k5.pack_weight(w)),
              f'K5 weight packing disagrees with its plain version at x {tuple(x.shape)}')
        # the trainable route (K5, K4's dx, cuDNN's dW) against F.conv2d's autograd
        g = torch.randn(y.shape, generator=gen, device='cuda')
        xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
        got = torch.autograd.grad(k5.disc_im2col(xr, wr, b, *geo), (xr, wr), g)
        ref = torch.autograd.grad(F.conv2d(xr, wr, b, stride=k5.STRIDE, padding=m.padding,
                                           dilation=m.dilation), (xr, wr), g)
        e_grad = [float((a - r).abs().max()) / float(r.abs().max()) for a, r in zip(got, ref)]
        del got, ref, xr, wr, g
        row = dict(x=list(x.shape), dilation=list(m.dilation))
        row['ms'] = cuda_ms(torch, lambda: k5.disc_im2col_forward(x, w, b, *geo))
        row['device_ms'] = device_ms(torch, lambda: k5.disc_im2col_forward(x, w, b, *geo))
        row['kernel_ms'] = cuda_ms(torch, lambda: k5.forward_packed(x, wk, b, *geo))
        row['packing_ms'] = cuda_ms(torch, lambda: k5.pack_weight_cuda(w))
        row['plain_ms'] = cuda_ms(torch, lambda: k5.disc_im2col_forward_plain(x, w, b, *geo),
                                  runs=5)
        row['library_ms'] = cuda_ms(torch, lambda: F.conv2d(
            x, w, b, stride=k5.STRIDE, padding=m.padding, dilation=m.dilation))
        row['k4_ms'] = cuda_ms(torch, lambda: dck.disc_conv_forward(x, w, b, k5.STRIDE, *geo))
        flops = 2.0 * y.numel() * w[0].numel()
        row['bound_ms'], row['bound_f32_ms'] = k4_bounds(
            flops, 4.0 * (x.numel() + w.numel() + b.numel() + y.numel()))
        row['gflop'] = flops / 1e9
        row['rel_err'] = max(e_plain, e_lib) / top
        line = (f'K5 disc_im2col x {tuple(x.shape)} dilation {m.dilation}, '
                f'{row["gflop"]:.2f} GFLOP: max |d| vs plain {e_plain:.3e}, vs cuDNN '
                f'{e_lib:.3e} ({row["rel_err"]:.2e} of max), from float64 {e64[0]:.2e} by norm, '
                f'bias {e64[1]:+.2e}; bit-equal on a repeat: {same}; '
                f'autograd dx, dW vs cuDNN {e_grad[0]:.2e}, {e_grad[1]:.2e} of max; wrapper '
                f'{row["ms"]:.4f} ms (on the device {fmt_ms(row["device_ms"])}; kernel '
                f'{row["kernel_ms"]:.4f} ms, weight packing {row["packing_ms"]:.4f} ms), plain '
                f'(im2col GEMM) {row["plain_ms"]:.4f} ms, cuDNN F.conv2d '
                f'{row["library_ms"]:.4f} ms, K4 forward {row["k4_ms"]:.4f} ms, bound '
                f'{row["bound_ms"]:.4f} ms (3xTF32) / {row["bound_f32_ms"]:.4f} ms (f32)')
        if before is not None:
            bk5 = before.disc_im2col_kernel
            y_before = bk5.disc_im2col_forward(x, w, b, *geo)
            row['before_ms'] = cuda_ms(torch, lambda: bk5.disc_im2col_forward(x, w, b, *geo))
            row['before_rel_d'] = float((y - y_before).abs().max()) / top
            row['equal_before'] = bool(torch.equal(y, y_before))
            line += (f'; the earlier kernel {row["before_ms"]:.4f} ms, max |d| between the two '
                     f'{row["before_rel_d"]:.2e} of max, bit-equal: {row["equal_before"]}')
            check(row['equal_before'],
                  f'K5 f32 is not bit-equal to the earlier kernel (--before) at x {tuple(x.shape)}')
            del y_before
        log(line)
        check(row['rel_err'] <= K5_TOL_REL and max(e_grad) <= K5_TOL_REL and same,
              f'K5 disagrees at x {tuple(x.shape)}: {e_plain}, {e_lib}, {e_grad}, repeat {same}')
        check(f64_ok(e64), f'K5 drifts from float64 at x {tuple(x.shape)}: {e64}')
        worst64 = max(worst64, e64[0])
        bias64 = max(bias64, abs(e64[1]))
        worst = max(worst, e_plain, e_lib)
        worst_grad = max(worst_grad, *e_grad)
        for k in keys:
            tot[k] += row[k] if row[k] is not None else float('nan')
        shapes.append(row)
        del y, y_lib
    log(f'K5 over one discriminator call (9 convs, {tot["gflop"]:.1f} GFLOP): wrapper '
        f'{tot["ms"]:.3f} ms (on the device {fmt_ms(tot["device_ms"])}; kernel '
        f'{tot["kernel_ms"]:.3f} ms, packing {tot["packing_ms"]:.3f} ms), plain '
        f'{tot["plain_ms"]:.3f} ms, cuDNN {tot["library_ms"]:.3f} ms, K4 forward '
        f'{tot["k4_ms"]:.3f} ms, bound {tot["bound_ms"]:.3f} ms (3xTF32) / '
        f'{tot["bound_f32_ms"]:.3f} ms (f32); worst autograd error {worst_grad:.2e} of max; '
        f'from float64 at most {worst64:.2e} by norm and {bias64:.2e} of bias'
        + (f'; the earlier kernel {tot["before_ms"]:.3f} ms' if before is not None else ''))
    return dict(max_abs_err=worst, **{k: v for k, v in tot.items() if k != 'gflop'},
                bound_by='operations', shapes=shapes)


def read_frames(model, data: bytes):
    """(header, [(scale or None, codes [K, T'])]) of a packed ``.ecdc``."""
    import math
    import struct

    from encodec_pytorch_tpu_torch import compress as C
    from encodec_pytorch_tpu_torch.bitstream.binary import read_ecdc_header
    fo = io.BytesIO(data)
    meta = read_ecdc_header(fo)
    frames = []
    offsets = range(0, meta['al'], model.segment_stride or meta['al'])
    for offset in offsets:
        this = min(meta['al'] - offset, model.segment_length or meta['al'])
        fr = meta['fr'] if len(offsets) == 1 else math.ceil(this * model.frame_rate
                                                             / model.sample_rate)
        scale = struct.unpack('!f', fo.read(4))[0] if model.normalize else None
        frames.append((scale, C._decompress_frame_packed(model, fo, meta['nc'], fr)))
    check(fo.read() == b'', 'bytes left after the last frame')
    return meta, frames


def codec48_phase(torch, seed, tmp: Path):
    """The 48 kHz codec CLI at full ``encodec_48khz`` width: 10 s stereo to
    ``.ecdc`` and back at 6 and 24 kbps; returns the K1, K2, K3 launch counts
    of the CLI run."""
    from encodec_pytorch_tpu_torch import cli
    from encodec_pytorch_tpu_torch import compress as C
    from encodec_pytorch_tpu_torch.models.model import encodec_model_48khz
    from encodec_pytorch_tpu_torch.utils import read_wav, write_wav

    ckpt = tmp / CKPT48
    write_seeded_checkpoint(torch, seed + 40, ckpt, 'encodec_48khz')
    wav_in, ecdc, wav_out = tmp / 'in48.wav', tmp / 'out48.ecdc', tmp / 'out48.wav'
    write_wav(wav_in, make_clip(seed + 41, 1, SECONDS, SR48, 2)[0], SR48)
    common = ['-q', '-c', str(ckpt), '--device', 'cuda', '-f']

    reset_counts()
    t0 = time.perf_counter()
    cli.main([str(wav_in), str(ecdc), '-b', '6', *common])
    cli.main([str(ecdc), str(wav_out), *common])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = read_counts()
    log(f'48 kHz: CLI -q compress + decompress of {SECONDS} s stereo in {cli_s:.2f} s (model '
        f'loads included); kernel launches {launches}')
    check(launches['rvq_encode'] > 0 and launches['lstm_recurrence'] > 0,
          f'the 48 kHz codec path did not go through K1 and K2: {launches}')
    check(launches['resblock'] == 0, f'a time_group_norm resblock took K3: {launches}')

    model = encodec_model_48khz(checkpoint=ckpt, device='cuda')
    model.set_target_bandwidth(6.)
    data = ecdc.read_bytes()
    meta, frames = read_frames(model, data)
    lengths = [c.shape[1] for _, c in frames]
    log(f'48 kHz: .ecdc {len(data)} bytes, header {meta}, {len(frames)} frames of code lengths '
        f'{lengths}, scales {[round(sc, 5) for sc, _ in frames]}')
    check(meta['m'] == 'encodec_48khz' and meta['al'] == SR48 * SECONDS and meta['nc'] == 4
          and meta['lm'] is False, f'bad header {meta}')
    check(len(frames) == 11 and lengths[:-1] == [150] * 10 and lengths[-1] == 15
          and all(sc is not None and sc > 0 for sc, _ in frames), 'bad frames')
    out, sr = read_wav(wav_out)
    check(sr == SR48 and out.shape == (2, SR48 * SECONDS) and np.isfinite(out).all(),
          f'bad output wav {out.shape} at {sr} Hz')

    wav, _ = read_wav(wav_in)
    x = torch.from_numpy(wav[None]).cuda()
    enc = model.encode(x)
    check(all(np.array_equal(fc, c[0].cpu().numpy()) and np.float32(sc) == float(s[0, 0])
              for (sc, fc), (c, s) in zip(frames, enc)),
          'the .ecdc codes or scales differ from the in-process encode')
    dec = model.decode(enc)[0, :, :SR48 * SECONDS].cpu().numpy()
    check(np.abs(out - np.clip(dec, -0.99, 0.99)).max() <= 2 / 32768,
          "the CLI's wav differs from the in-process decode")
    with plain_path():
        enc_p = model.encode(x)
        dec_p = model.decode(enc_p)[0, :, :SR48 * SECONDS].cpu().numpy()
    codes, codes_p = (torch.cat([c for c, _ in e], -1) for e in (enc, enc_p))
    same = float((codes == codes_p).float().mean())
    snr = snr_db(dec_p, dec)
    sm = model.encode_segmajor(x)
    same_sm = float((codes == torch.cat([c for c, _ in sm], -1)).float().mean())
    log(f'48 kHz 6 kbps: identical codes kernel vs plain {same:.6f}, decode SNR kernel vs plain '
        f'{snr:.2f} dB, encode_segmajor vs encode {same_sm:.6f}; distinct codes used '
        f'{len(torch.unique(codes))}')
    check(same >= K1_TOL_SHARE and snr >= SNR_MIN_DB and same_sm >= K1_TOL_SHARE,
          '48 kHz kernel path disagrees with plain path or segment-major encode')

    def round_trip():
        return C.decompress(model, C.compress(model, wav))

    round_trip()
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        round_trip()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    t1 = statistics.median(times)
    log(f'48 kHz RTF round trip (compress + decompress, B=1, {SECONDS} s stereo): '
        f'{SECONDS / t1:.2f} (median {t1 * 1000:.1f} ms of 3)')

    model.set_target_bandwidth(24.)
    data24 = C.compress(model, wav)
    meta24, frames24 = read_frames(model, data24)
    out24, _ = C.decompress(model, data24)
    enc24 = model.encode(x)
    with plain_path():
        enc24_p = model.encode(x)
    same24 = float((torch.cat([c for c, _ in enc24], -1)
                    == torch.cat([c for c, _ in enc24_p], -1)).float().mean())
    log(f'48 kHz 24 kbps: header nc {meta24["nc"]}, {len(data24)} bytes, {len(frames24)} frames, '
        f'identical codes kernel vs plain {same24:.6f}')
    check(meta24['nc'] == 16 and len(frames24) == 11 and out24.shape == (2, SR48 * SECONDS)
          and np.isfinite(out24).all() and same24 >= K1_TOL_SHARE, '48 kHz 24 kbps run failed')
    return launches


def server48_phase(torch, seed, ckpt: Path):
    """A CodecServer on the 48 kHz model (segment-major by default): 8
    concurrent stereo round trips of 1.5-10 s in four pairs of lengths;
    returns the K1, K2, K3 launch counts of the served requests."""
    import threading

    from encodec_pytorch_tpu_torch.models.model import encodec_model_48khz
    from encodec_pytorch_tpu_torch.serve import CodecServer, LiveCodec

    model = encodec_model_48khz(checkpoint=ckpt, device='cuda')
    codec = LiveCodec(model, default_bandwidth=6., device='cuda')
    check(codec.segment_major, 'the 48 kHz LiveCodec is not segment-major')
    lengths = [72000, 144000, 288000, 480000] * 2
    reqs = [make_clip(seed + 600 + i, 1, n / SR48, SR48, 2)[0] for i, n in enumerate(lengths)]
    direct = [codec.roundtrip(r[None])[0].cpu().numpy() for r in reqs]
    results = [None] * len(reqs)
    reset_counts()
    with CodecServer(codec, max_batch=8, max_wait_ms=50.0) as cs:
        def call(i):
            results[i] = cs.roundtrip(reqs[i], timeout=120)
        threads = [threading.Thread(target=call, args=(i,)) for i in range(len(reqs))]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        wall = time.perf_counter() - t0
        cstats = cs.stats()
    launches = read_counts()
    check(all(r is not None for r in results), 'a CodecServer request did not finish')
    snrs = []
    for r, d, n in zip(results, direct, lengths):
        check(r.shape == (2, n), f'CodecServer result {r.shape} for {n} samples')
        snrs.append(snr_db(d, r))
    log(f'48 kHz serving: CodecServer 8 concurrent stereo round trips of {sorted(set(lengths))} '
        f'samples, 2 each: {cstats["batches"]} batches, mean batch {cstats["mean_batch"]:.2f}, '
        f'latency ms p50 {cstats["latency_p50_ms"]:.2f}, {sum(lengths) / SR48:.1f} audio s in '
        f'{wall:.3f} s; vs direct calls min SNR {min(snrs):.2f} dB; kernel launches {launches}')
    check(min(snrs) >= SNR_MIN_DB and cstats['batches'] < len(reqs),
          '48 kHz CodecServer results disagree with direct calls, or nothing coalesced')
    check(launches['resblock'] == 0, f'a time_group_norm resblock took K3: {launches}')
    return launches


def _flat(module, grads: bool):
    import torch
    return torch.cat([(p.grad if grads else p.detach()).reshape(-1)
                      for p in module.parameters()])


def busy_ms(torch, prof, steps: int = 1) -> float:
    """Device milliseconds a step in kernels, from a ``torch.profiler`` run
    over ``steps`` steps."""
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / steps


def training_phase(torch, seed, tmp: Path, config: str = 'config', extra=(), label=None,
                   entries=None):
    """The training path of the default set ``config`` (with ``extra``
    overrides) and its kernel-vs-plain step, the latter profiled: returns the
    launch counts of ``entries`` (K4's f32 entries and K2, and K5's under
    ``config_48k_stereo``, by default) on the training path, and the step's
    summary (ms after the first, device busy and idle share of the profiled
    step, peak memory)."""
    import copy

    from encodec_pytorch_tpu_torch import train_cli
    from encodec_pytorch_tpu_torch.ops import disc_conv_kernel as dck
    from encodec_pytorch_tpu_torch.ops import disc_im2col_kernel as k5
    from encodec_pytorch_tpu_torch.ops import lstm_kernel
    from encodec_pytorch_tpu_torch.train.step import make_optimizer, train_step
    from encodec_pytorch_tpu_torch.train.trainer import (build_disc_from_config,
                                                         build_model_from_config)

    label = label or config
    sr, channels, _, _ = TRAIN_DATA[config]
    overrides = train_overrides(tmp, seed, config) + list(extra)
    if entries is None:
        entries = {'disc_conv_forward': dck.disc_conv_forward,
                   'disc_conv_input_grad': dck.disc_conv_input_grad,
                   'lstm_recurrence': lstm_kernel.lstm_recurrence}
        if config != 'config':
            entries['disc_im2col_forward'] = k5.disc_im2col_forward
    torch.cuda.reset_peak_memory_stats()
    for fn in entries.values():
        fn.launches = 0
    t0 = time.perf_counter()
    trainer = train_cli.main(['--device', 'cuda', '--config', config, *overrides])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in entries.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    summary = trainer.history[-1]
    step_ms = summary['step_ms']
    dtype = trainer.model.encoder.dtype
    log(f'training {label}: train_cli, {summary["steps"]} steps of '
        f'{trainer.config.datasets.batch_size} x {channels} x {trainer.tensor_cut} in {dtype} in '
        f'{wall:.2f} s (set-up included); ms per step '
        f'{[round(t, 1) for t in step_ms]}, median after the first '
        f'{statistics.median(step_ms[1:]):.1f} ms; peak memory {peak_gb:.2f} GB; '
        f'kernel launches {launches}')
    log(f'training {label}: epoch means ' + json.dumps(
        {k: v for k, v in summary.items() if k not in ('step_ms', 'steps')}))
    check(summary['steps'] == 3, f'expected 3 steps, ran {summary["steps"]}')
    check(all(v > 0 for v in launches.values()),
          f'the training path did not go through every kernel: {launches}')
    check(all(np.isfinite(v) for k, v in summary.items() if k not in ('step_ms', 'steps')),
          'non-finite training metrics')
    check(summary['disc_updated'] == 1.0, 'the discriminator was not updated')

    init = torch.Generator().manual_seed(int(trainer.config.common.seed))
    model0 = build_model_from_config(trainer.config, 'cuda', init)
    disc0 = build_disc_from_config(trainer.config, 'cuda', init)
    moved = {
        'generator': float((_flat(trainer.model, False) - _flat(model0, False)).abs().max()),
        'discriminator': float((_flat(trainer.disc, False) - _flat(disc0, False)).abs().max()),
        'codebooks': float((trainer.model.quantizer.vq.embeds(trainer.model.quantizer.n_q)
                            - model0.quantizer.vq.embeds(model0.quantizer.n_q)).abs().max()),
    }
    log(f'training {label}: max |change| of the parameters from their seeded init {moved}')
    check(all(v > 0 and np.isfinite(v) for v in moved.values()), f'not everything trained: {moved}')

    # the most stages whose k-means init already ran, so that both runs start
    # from the same codebooks
    inited = [bool(layer._codebook.inited) for layer in trainer.model.quantizer.vq.layers]
    n_q = max(n for n in trainer.n_q_table if all(inited[:n]))
    log(f'training {label}: the kernel-vs-plain step runs at n_q {n_q}')
    batch = torch.from_numpy(make_clip(seed + 9, int(trainer.config.datasets.batch_size),
                                       trainer.tensor_cut / sr, sr, channels)).cuda()
    m_k, m_p, rel, prof_ms, prof = kernel_vs_plain_step(
        torch, trainer.model, trainer.disc, trainer.balancer, trainer.opt_g, trainer.opt_d,
        batch, n_q, sr, seed)
    busy = busy_ms(torch, prof)
    out = dict(step_ms=statistics.median(step_ms[1:]), busy_ms=busy, idle=1 - busy / prof_ms,
               peak_gb=peak_gb, dtype=str(dtype))
    log(f'training {label}: one step kernels vs plain from the trained state: loss relative '
        f'diffs {rel["loss"]}; gradient relative norm diffs (generator, discriminator) '
        f'{rel["grad"]}; update relative norm diffs {rel["update"]}; the kernel step under '
        f'torch.profiler: wall {prof_ms:.1f} ms, device busy {busy:.1f} ms, idle share '
        f'{out["idle"]:.3f}')
    bars = ((TRAIN_LOSS_REL, TRAIN_GRAD_REL, TRAIN_UPDATE_REL) if dtype == torch.float32
            else (TRAIN_BF16_LOSS_REL, TRAIN_BF16_GRAD_REL, TRAIN_BF16_UPDATE_REL))
    check(all(v <= bars[0] for v in rel['loss'].values())
          and all(v <= bars[1] for v in rel['grad'])
          and all(v <= bars[2] for v in rel['update']),
          f'the kernel step disagrees with the plain step (bars {bars})')
    return launches, out


def kernel_vs_plain_step(torch, model0, disc0, balancer0, opt_g0, opt_d0, batch, n_q: int,
                         sr: int, seed: int, train_disc: bool = True):
    """One step from the given state twice, on copies: through the kernels
    (under ``torch.profiler``) and with every kernel swapped for its plain
    version, the discriminator updated or not as ``train_disc`` says.
    Returns (kernel metrics, plain metrics, relative differences of the
    losses, the gradients (the generator's, and the discriminator's when it
    trains) and the updates, the profiled step's wall ms, the profiler)."""
    import copy

    from encodec_pytorch_tpu_torch.train.step import make_optimizer, train_step

    def one_step(plain: bool):
        model, disc = copy.deepcopy(model0), copy.deepcopy(disc0)
        opt_g, opt_d = make_optimizer(model.parameters()), make_optimizer(disc.parameters())
        # deep copies: load_state_dict keeps the very state tensors it is given
        opt_g.load_state_dict(copy.deepcopy(opt_g0.state_dict()))
        opt_d.load_state_dict(copy.deepcopy(opt_d0.state_dict()))
        before = _flat(model, False), _flat(disc, False)
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        torch.cuda.synchronize()
        with (plain_path() if plain else torch.profiler.profile(activities=acts)) as prof:
            t0 = time.perf_counter()
            metrics = train_step(model, disc, copy.deepcopy(balancer0), opt_g, opt_d,
                                 batch, n_q=n_q, train_disc=train_disc, lr_g=3e-4, lr_d=3e-4,
                                 sample_rate=sr,
                                 generator=torch.Generator(device='cuda').manual_seed(seed))
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0)
        return ({k: float(v) for k, v in metrics.items()},
                (_flat(model, True),) + ((_flat(disc, True),) if train_disc else ()),
                (_flat(model, False) - before[0], _flat(disc, False) - before[1]), wall, prof)

    m_k, g_k, u_k, wall, prof = one_step(plain=False)
    m_p, g_p, u_p, _, _ = one_step(plain=True)
    diffs = {'loss': {k: abs(m_k[k] - m_p[k]) / max(abs(m_p[k]), 1e-30)
                      for k in ('l_t', 'l_f', 'l_g', 'l_feat', 'loss_w', 'loss_disc')},
             'grad': [_rel_norm(a, b) for a, b in zip(g_k, g_p)],
             'update': [_rel_norm(a, b) for a, b in zip(u_k, u_p)]}
    return m_k, m_p, diffs, wall, prof


TRAIN_KERNELS = ('disc_conv_forward', 'disc_conv_input_grad')
STATE_EPOCHS = 2
STATE_CUT_AFTER = 4      # SIGTERM after this many of the run's 6 steps: mid-epoch 2
STATE_REL = 1e-3
STATE_TICKS = 50


def _all_entries():
    from encodec_pytorch_tpu_torch.ops import disc_conv_kernel as dck
    return dict(_codec_entries(), disc_conv_forward=dck.disc_conv_forward,
                disc_conv_input_grad=dck.disc_conv_input_grad)


def _rel_norm(a, b) -> float:
    import torch
    den = float(torch.linalg.vector_norm(b))
    return float(torch.linalg.vector_norm(a - b)) / den if den > 0 else float(
        torch.linalg.vector_norm(a))


def _state_groups(trainer) -> dict:
    """The trained state, flattened on the host in three groups: parameters
    (generator and discriminator), Adam moments, RVQ EMA buffers."""
    import torch
    params = [p.detach() for m in (trainer.model, trainer.disc) for p in m.parameters()]
    moments = [opt.state[p][k] for opt in (trainer.opt_g, trainer.opt_d)
               for p in opt.param_groups[0]['params'] if p in opt.state
               for k in ('exp_avg', 'exp_avg_sq')]
    rvq = [b for s in trainer.model.quantizer.vq.states() for b in s]
    return {name: torch.cat([t.reshape(-1).float().cpu() for t in group])
            for name, group in (('parameters', params), ('adam moments', moments),
                                ('rvq buffers', rvq))}


def _tick_ms(torch, server, clips, first: int, ticks: int) -> list:
    """Host clock around each batched step of a 16-slot mux, every slot
    active, ending in a synchronize."""
    mask = torch.ones(server.max_streams, dtype=torch.bool, device='cuda')
    out = []
    for k in range(ticks):
        a = first + k * server.chunk_samples
        x = torch.from_numpy(np.ascontiguousarray(clips[:, :, a:a + server.chunk_samples]))
        t0 = time.perf_counter()
        wav, _, server._enc_state, server._dec_state = server._mux(
            server._enc_state, server._dec_state, x.cuda(), mask)
        wav.cpu()
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t0))
    return out


def _pct(values, q: float) -> float:
    v = sorted(values)
    return v[min(len(v) - 1, int(q * len(v)))]


@contextlib.contextmanager
def deterministic(torch):
    """cuDNN's deterministic algorithms and torch's deterministic mode (as
    warnings) inside; yields a set that collects the first line of each
    warning of an op without a deterministic form."""
    import warnings
    saved = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
             torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled())
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    torch.use_deterministic_algorithms(True, warn_only=True)
    found = set()
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter('always')
            try:
                yield found
            finally:
                found.update(str(w.message).splitlines()[0][:200] for w in caught
                             if 'determinis' in str(w.message))
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved[:2]
        torch.use_deterministic_algorithms(saved[2], warn_only=saved[3])


def cut_and_resume(torch, tmp: Path, overrides: list, label: str) -> dict:
    """An uncut ``train_cli`` run against one that gets a real SIGTERM after
    step :data:`STATE_CUT_AFTER`, must exit with 143 leaving a ``_preempt``
    file beside the unharmed epoch file, and is resumed from it; both with
    deterministic algorithms. Returns the relative norm of each state group's
    difference and whether it is bit-equal."""
    import signal

    from encodec_pytorch_tpu_torch import train_cli
    from encodec_pytorch_tpu_torch.train import checkpoint
    from encodec_pytorch_tpu_torch.train import trainer as trainer_module

    # Two runs of the same seed already differ in cuDNN's default mode (its
    # weight-gradient algorithms need not be deterministic), and the RVQ's
    # k-means and expiry amplify any difference; so the run that is cut and
    # resumed, and the uncut run it is held to, use deterministic algorithms.
    real_step = trainer_module.train_step
    taken = []

    def hooked(*args, **kwargs):
        out = real_step(*args, **kwargs)
        taken.append(1)
        if len(taken) == STATE_CUT_AFTER:
            os.kill(os.getpid(), signal.SIGTERM)
        return out

    with deterministic(torch) as nondeterministic:
        reference = train_cli.main(['--device', 'cuda', *overrides,
                                    f'checkpoint.save_folder={tmp}/reference/'])
        trainer_module.train_step = hooked
        try:
            train_cli.main(['--device', 'cuda', *overrides, f'checkpoint.save_folder={tmp}/cut/'])
            code = 0
        except SystemExit as e:
            code = e.code
        finally:
            trainer_module.train_step = real_step
        preempt = sorted(Path(tmp, 'cut').glob('*epoch1_preempt_*.ckpt'))
        resumed = None if not preempt else train_cli.main([
            '--device', 'cuda', *overrides, f'checkpoint.save_folder={tmp}/cut/',
            'checkpoint.resume=True', f'checkpoint.checkpoint_path={preempt[0]}'])
    log(f'trainer state, {label}: deterministic runs (cudnn.deterministic, '
        'use_deterministic_algorithms warning only): ms per step of the uncut one '
        f'{[round(t, 1) for h in reference.history for t in h["step_ms"]]}; ops that warned '
        f'of no deterministic form {sorted(nondeterministic)}')
    boundary = sorted(Path(tmp, 'cut').glob('*epoch1_lr*.ckpt'))
    log(f'trainer state, {label}: cut run exited with {code} after {len(taken)} steps; files '
        f'{[p.name for p in Path(tmp, "cut").glob("*.ckpt")]}')
    check(code == 128 + signal.SIGTERM and len(taken) == STATE_CUT_AFTER,
          f'{label}: the cut run did not exit with 143 after step {STATE_CUT_AFTER}: {code}')
    check(len(preempt) == 1 and len(boundary) == 1
          and checkpoint.load_checkpoint(str(boundary[0]))[0]['step'] == 3
          and checkpoint.load_checkpoint(str(preempt[0]))[0]['step'] == STATE_CUT_AFTER,
          f'{label}: the _preempt file is missing or the epoch file was harmed')
    check(resumed is not None and resumed.step == reference.step == 3 * STATE_EPOCHS,
          f'{label}: the resumed run did not finish')
    got, want = _state_groups(resumed), _state_groups(reference)
    rel = {k: _rel_norm(got[k], want[k]) for k in want}
    equal = {k: bool(torch.equal(got[k], want[k])) for k in want}
    log(f'trainer state, {label}: cut at step {STATE_CUT_AFTER} and resumed vs uncut (both '
        f'deterministic), relative norm differences {rel}, bit-equal {equal}')
    check(max(rel.values()) <= STATE_REL, f'{label}: the resumed run left the uncut trajectory: '
          f'{rel}')
    return {'rel': rel, 'equal': equal}


def trainer_state_phase(torch, seed, tmp: Path, smi: str) -> dict:
    """The trainer's state on the card: an uncut run, a run cut by SIGTERM
    and resumed, the trained checkpoint through the CLI's ``my_encodec`` and
    ``encodec_bw``, then the weight-norm fold (CLI bytes and the mux tick).
    Returns the kernels' launch counts over the phase."""
    from encodec_pytorch_tpu_torch import cli, train_cli
    from encodec_pytorch_tpu_torch.models.model import MODELS, encodec_model_24khz
    from encodec_pytorch_tpu_torch.prepare import fold_weight_norm
    from encodec_pytorch_tpu_torch.serve import StreamingServer
    from encodec_pytorch_tpu_torch.train import trainer as trainer_module
    from encodec_pytorch_tpu_torch.utils import read_wav, write_wav

    entries = _all_entries()
    for fn in entries.values():
        fn.launches = 0
    counts = lambda: {k: fn.launches for k, fn in entries.items()}
    log(f'trainer state on {smi}')
    # the my_encodec architecture; n_q 8 so that encodec_bw at 6 kbps (n_q 8)
    # loads the same file
    overrides = train_overrides(tmp, seed) + [
        f'common.max_epoch={STATE_EPOCHS}', 'common.save_interval=1', 'common.test_interval=1',
        'model.causal=False', 'model.norm=time_group_norm', 'model.n_q=8',
        'tpu.compute_dtype=float32']
    in_tests = dict.fromkeys(entries, 0)
    real_test = trainer_module.Trainer.test

    def counted_test(self, epoch):
        before = counts()
        out = real_test(self, epoch)
        for k, v in counts().items():
            in_tests[k] += v - before[k]
        return out

    trainer_module.Trainer.test = counted_test
    try:
        uncut = train_cli.main(['--device', 'cuda', *overrides,
                                f'checkpoint.save_folder={tmp}/uncut/'])
    finally:
        trainer_module.Trainer.test = real_test
    cfg = uncut.config
    steps = [round(t, 1) for h in uncut.history for t in h['step_ms']]
    log(f'trainer state: uncut run, {len(steps)} steps of {cfg.datasets.batch_size} x 1 x '
        f'{uncut.tensor_cut} (n_filters {uncut.model.encoder.n_filters}, n_q '
        f'{uncut.model.quantizer.n_q}, causal False, time_group_norm), ms per step {steps}')
    for t in uncut.test_history:
        log(f'trainer state: test loop epoch {t["epoch"]}: {t["ms"]:.1f} ms for '
            f'{len(uncut.testloader)} batch(es); losses ' + json.dumps(
                {k: round(v, 6) for k, v in t.items() if k not in ('ms', 'epoch')}))
    for rec in uncut.writer.history:
        log(f'trainer state: save {Path(rec["path"]).name}: snapshot {rec["snapshot_ms"]:.1f} ms '
            f'(caller thread), write {rec["write_ms"]:.1f} ms (writer thread), '
            f'{rec["bytes"] / 1e6:.1f} MB')
    log(f'trainer state: kernel launches inside the test loops {in_tests}')
    check(len(steps) == 3 * STATE_EPOCHS and len(uncut.test_history) == STATE_EPOCHS + 1,
          'the uncut run did not take its steps and test loops')
    check(all(np.isfinite(v) for t in uncut.test_history for v in t.values()),
          'non-finite test losses')
    check(all(in_tests[k] > 0 for k in ('rvq_encode', 'lstm_recurrence', 'disc_conv_forward')),
          f'the test loops did not launch K1, K2 and K4: {in_tests}')
    for name in ('GT.wav', 'Reconstruction.wav'):
        wav, _ = read_wav(Path(cfg.checkpoint.save_folder) / name)
        check(wav.shape[-1] > 0 and np.isfinite(wav).all(), f'bad {name}')
    final = uncut.writer.history[-1]['path']
    again = train_cli.main(['--device', 'cuda', *overrides, f'checkpoint.save_folder={tmp}/again/'])
    got, want = _state_groups(again), _state_groups(uncut)
    log('trainer state: a second uncut run against the first, both in cuDNN\'s default mode: '
        f'relative norm differences { {k: _rel_norm(got[k], want[k]) for k in want} }, '
        f'bit-equal { {k: bool(torch.equal(got[k], want[k])) for k in want} }')
    del again

    resume = {'float32': cut_and_resume(torch, tmp / 'f32', overrides, 'float32')}
    overrides16 = [o for o in overrides if o != 'tpu.compute_dtype=float32']
    resume['bfloat16'] = cut_and_resume(torch, tmp / 'bf16',
                                        overrides16 + ['tpu.compute_dtype=bfloat16'], 'bfloat16')

    x = make_clip(seed + 40, batch=1)
    wav_in, ecdc, wav_out = tmp / 'clip.wav', tmp / 'trained.ecdc', tmp / 'trained.wav'
    write_wav(wav_in, x[0], SR)
    clip = torch.from_numpy(read_wav(wav_in)[0][None]).cuda()
    generator = uncut.model.eval()
    for name, segment in (('my_encodec', None), ('encodec_bw', 1.)):
        common = ['-m', name, '-c', final, '-b', '6', '--device', 'cuda', '-f']
        reset_counts()
        cli.main([str(wav_in), str(ecdc), *common])
        cli.main([str(ecdc), str(wav_out), *common])
        launches = read_counts()
        generator.segment = segment       # encodec_bw's 1 s segments
        generator.set_target_bandwidth(6.)
        frames = generator.encode(clip)
        length = clip.shape[-1]
        ref = generator.decode(frames)[0, :, :length].cpu().numpy()
        loaded = (MODELS[name](final, 6., device='cuda') if name == 'encodec_bw'
                  else MODELS[name](final, device='cuda'))
        loaded.set_target_bandwidth(6.)
        got_frames = loaded.encode(clip)
        dec = loaded.decode(got_frames)[0, :, :length].cpu().numpy()
        same = float(np.mean([float((a[0] == b[0]).float().mean())
                              for a, b in zip(got_frames, frames)]))
        out, _ = read_wav(wav_out)
        snr = snr_db(ref, dec)
        cli_d = float(np.abs(out - np.clip(dec, -0.99, 0.99)).max())
        log(f'trainer state: cli -m {name} -b 6 on the epoch-{STATE_EPOCHS} checkpoint, '
            f'{SECONDS} s: {len(frames)} frame(s), codes equal to the trainer\'s generator '
            f'{same:.6f}, decode SNR against its decode {snr:.2f} dB, the CLI\'s wav within '
            f'{cli_d:.2e} of the decode; launches {launches}')
        check(launches['rvq_encode'] > 0 and launches['lstm_recurrence'] > 0,
              f'{name} did not run K1 and K2: {launches}')
        check(same == 1.0 and snr >= SNR_MIN_DB and cli_d <= 2 / 32768,
              f'{name} disagrees with the trainer')
    generator.segment = None
    del uncut, generator

    ckpt = tmp / CKPT
    write_seeded_checkpoint(torch, seed, ckpt)
    streams = {}
    for weights in ('raw', 'fold'):
        common = ['-m', 'encodec_24khz', '-c', str(ckpt), '-b', '6', '--device', 'cuda', '-f',
                  '--weights', weights]
        reset_counts()
        cli.main([str(wav_in), str(tmp / f'{weights}.ecdc'), *common])
        streams[weights] = (tmp / f'{weights}.ecdc').read_bytes()
        log(f'trainer state: cli --weights {weights}: {len(streams[weights])} bytes, launches '
            f'{read_counts()}')
    check(read_counts()['resblock'] > 0, 'the folded codec did not run K3')
    check(streams['fold'] == streams['raw'], 'folded .ecdc bytes differ from the raw ones')

    model = encodec_model_24khz(checkpoint=ckpt, device='cuda')
    model.set_target_bandwidth(6.)
    servers = {'raw': StreamingServer(model, max_streams=STREAMS, chunk_hops=CHUNK_HOPS,
                                      bandwidth=6., device='cuda'),
               'fold': StreamingServer(fold_weight_norm(model), max_streams=STREAMS,
                                       chunk_hops=CHUNK_HOPS, bandwidth=6., device='cuda')}
    hop = model.encoder.hop_length
    first = FIRST_HOPS * hop
    chunk = servers['raw'].chunk_samples
    clips = make_clip(seed + 60, STREAMS, (first + (2 * STATE_TICKS + 3) * chunk) / SR)
    for server in servers.values():
        for slot in range(STREAMS):
            server._first_chunk(slot, clips[slot][:, :first])
        _tick_ms(torch, server, clips, first, 3)
    ticks = {'raw': [], 'fold': []}
    for k, weights in enumerate(('raw', 'fold', 'fold', 'raw')):
        start = first + (3 + (k // 2) * STATE_TICKS) * chunk
        ticks[weights] += _tick_ms(torch, servers[weights], clips, start, STATE_TICKS)
    for weights, t in ticks.items():
        log(f'trainer state: mux tick ({STREAMS} slots x {CHUNK_HOPS} hops, {weights} weights, '
            f'{len(t)} ticks, raw/fold/fold/raw): host ms a tick mean {statistics.mean(t):.3f}, '
            f'p50 {_pct(t, 0.5):.3f}, p99 {_pct(t, 0.99):.3f} on {smi}')
    log(f'trainer state: kernel launches over the phase {counts()}')
    return counts()


LM24 = 'lm_24khz_seeded.th'
LM48 = 'lm_48khz_seeded.th'


# the mono-nq2 phase's scene tree (eigenscape's layout: 6 train and 2 test
# folders of ambisonic recordings): 32 channels at 48 kHz, so that every item
# is resampled; 16 test files so that the fixed validation segments (one a
# file) are 16 distinct ones
SCENE_SR = 48_000
SCENE_CHANNELS = 32
SCENE_SECONDS = {'train': 6, 'test': 2}
SCENE_TEST_FILES = 8           # in each of the 2 test folders
MONO_NQ2_CUTS = ['datasets.fixed_length=48', 'common.max_epoch=1', 'common.save_interval=1',
                 'lr_scheduler.warmup_epoch=0']
MONO_NQ2_SEGMENTS = 16
MEL_CARD_REL = 1e-4


def write_scene_tree(root: Path, seed: int) -> int:
    """The scene tree under ``root``: one file in each train folder and
    ``SCENE_TEST_FILES`` in each test folder, 16-bit PCM, each channel two
    tones of its own plus noise. Returns its size in bytes."""
    from encodec_pytorch_tpu_torch.data.multi_channel import TEST_FOLDERS, TRAIN_FOLDERS
    from encodec_pytorch_tpu_torch.utils import write_wav
    rng = np.random.default_rng(seed)
    size = 0
    for mode, folders, n_files in (('train', TRAIN_FOLDERS, 1),
                                   ('test', TEST_FOLDERS, SCENE_TEST_FILES)):
        t = np.arange(SCENE_SECONDS[mode] * SCENE_SR) / SCENE_SR
        for folder in folders:
            for i in range(n_files):
                freqs = rng.uniform(80, 6000, (SCENE_CHANNELS, 2, 1))
                amps = rng.uniform(0.05, 0.3, (SCENE_CHANNELS, 2, 1))
                wav = (amps * np.sin(2 * np.pi * freqs * t)).sum(1)
                wav += 0.02 * rng.standard_normal(wav.shape)
                path = root / folder / f'scene_{i}.wav'
                write_wav(path, wav.astype(np.float32), SCENE_SR)
                size += path.stat().st_size
    return size


def mono_nq2_phase(torch, seed, tmp: Path, smi: str) -> dict:
    """The reference's second training mode at ``config_mono_nq2``'s full
    width: ``train_cli`` through the multi-channel scene set, the resume
    through ``config_mono_nq2_resume``, kernels against plain with the
    discriminator's coin forced both ways, then the trained codec's decode of
    the fixed validation segments at 1.5 kbps scored by ``cal_metrics`` on
    the card. Returns the kernels' launch counts on the training and decode
    paths."""
    import logging

    from encodec_pytorch_tpu_torch import cal_metrics, metrics, train_cli
    from encodec_pytorch_tpu_torch.data import MultiChannelAudioDataset
    from encodec_pytorch_tpu_torch.utils import write_wav

    entries = _all_entries()
    names = CODEC_KERNELS + TRAIN_KERNELS
    t0 = time.perf_counter()
    nbytes = write_scene_tree(tmp / 'scenes', seed + 13)
    log(f'mono nq2: scene tree of {len(list((tmp / "scenes").rglob("*.wav")))} files '
        f'({SCENE_CHANNELS} channels, {SCENE_SR} Hz, 16-bit), {nbytes / 1e6:.1f} MB, written in '
        f'{time.perf_counter() - t0:.2f} s')
    save = tmp / 'checkpoints'
    common = [f'datasets.data_root={tmp / "scenes"}', f'checkpoint.save_folder={save}/',
              'common.log_interval=1', f'common.seed={seed}']
    warnings = []          # the trainers' warnings
    handler = logging.Handler(logging.WARNING)
    handler.emit = lambda record: warnings.append(record.getMessage())
    logging.getLogger('encodec_pytorch_tpu_torch').addHandler(handler)
    try:
        for fn in entries.values():
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        trainer = train_cli.main(['--device', 'cuda', '--config', 'config_mono_nq2',
                                  *common, *MONO_NQ2_CUTS])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        ckpt = Path(f'{trainer.config.checkpoint.save_location}epoch1_lr'
                    f'{trainer.config.optimization.lr}.ckpt')
        t0 = time.perf_counter()
        resumed = train_cli.main(['--device', 'cuda', '--config', 'config_mono_nq2_resume',
                                  *common, *MONO_NQ2_CUTS, f'checkpoint.checkpoint_path={ckpt}',
                                  'common.max_epoch=2'])
        torch.cuda.synchronize()
        resume_wall = time.perf_counter() - t0
        launches = {k: entries[k].launches for k in names}
    finally:
        logging.getLogger('encodec_pytorch_tpu_torch').removeHandler(handler)

    cfg, model = trainer.config, trainer.model
    summary, again = trainer.history[-1], resumed.history[-1]
    step_ms, data_ms = summary['step_ms'], trainer.data_ms
    batch, cut = int(cfg.datasets.batch_size), trainer.tensor_cut
    tb = [w for w in warnings if w.startswith('tensorboard unavailable')]
    events = sorted((save / 'runs').glob('events.out.tfevents.*'))
    log(f'mono nq2 on {smi}: train_cli --config config_mono_nq2 at full width (my_encodec, '
        f'causal, weight_norm, filters {cfg.model.filters}, ratios {list(cfg.model.ratios)}, '
        f'n_q {model.quantizer.n_q}, {model.encoder.dtype}), {summary["steps"]} steps of '
        f'{batch} x 1 x {cut} (1 s windows of one random channel of a random scene file, '
        f'resampled {SCENE_SR} -> {cfg.model.sample_rate} Hz), train_discriminator '
        f'{cfg.model.train_discriminator}; cut in depth only: {" ".join(MONO_NQ2_CUTS)} '
        f'(the yaml: fixed_length 27600, max_epoch 300, save_interval 2, warmup_epoch 5); '
        f'{len(trainer.testloader)} test batches; {wall:.2f} s (set-up included); ms per step '
        f'{[round(t, 1) for t in step_ms]}, median after the first '
        f'{statistics.median(step_ms[1:]):.1f} ms; the loader\'s host ms a batch (16 ranged '
        f'reads of 32 channels, resample, crop) {[round(t, 1) for t in data_ms]}, median '
        f'{statistics.median(data_ms):.1f} ms; peak memory {peak_gb:.2f} GB; disc updated on '
        f'{summary["disc_updated"] * summary["steps"]:.0f} of {summary["steps"]} steps')
    log(f'mono nq2: resume through config_mono_nq2_resume from {ckpt.name}: epoch '
        f'{resumed.resume_epoch + 1}, {again["steps"]} steps, {resume_wall:.2f} s, ms per step '
        f'{[round(t, 1) for t in again["step_ms"]]}; epoch means ' + json.dumps(
            {k: round(v, 5) for k, v in again.items() if k not in ('step_ms', 'steps')}))
    log('mono nq2: tensorboard: ' + (f'{len(events)} event file(s) written under {save}/runs'
                                      if events else f'not written, the trainer warned: {tb}'))
    log(f'mono nq2: kernel launches on the training path (train_cli and the resume) {launches}')
    check(isinstance(trainer.trainset, MultiChannelAudioDataset)
          and model.quantizer.n_q == 2 and model.encoder.dtype == torch.float32
          and (batch, cut) == (16, 24000) and cfg.model.train_discriminator == 0.5,
          'the mono-nq2 run is not at the yaml\'s widths')
    check(summary['steps'] == 3 and len(trainer.testloader) == 3, 'expected 3 steps and 3 test '
          f'batches, ran {summary["steps"]} and {len(trainer.testloader)}')
    check(resumed.resume_epoch == 1 and again['steps'] == 3 and resumed.step == 6,
          'the resume did not train epoch 2')
    for s in (summary, again):
        check(all(np.isfinite(v) for k, v in s.items() if k not in ('step_ms', 'steps')),
              'non-finite training metrics')
    check(bool(events) != bool(tb), f'tensorboard neither written nor warned: {tb}')
    check(all(launches[k] > 0 for k in TRAIN_KERNELS + ('lstm_recurrence',)),
          f'the training path did not go through K4 and K2: {launches}')

    inited = [bool(layer._codebook.inited) for layer in resumed.model.quantizer.vq.layers]
    check(all(inited), f'codebooks not initialized: {inited}')
    clips = torch.from_numpy(make_clip(seed + 21, batch, cut / SR)).cuda()
    out = {'step_ms': statistics.median(step_ms[1:]), 'data_ms': statistics.median(data_ms),
           'peak_gb': peak_gb}
    for coin in (True, False):
        m_k, m_p, rel, prof_ms, prof = kernel_vs_plain_step(
            torch, resumed.model, resumed.disc, resumed.balancer, resumed.opt_g,
            resumed.opt_d, clips, 2, SR, seed, train_disc=coin)
        busy = busy_ms(torch, prof)
        log(f'mono nq2: one step kernels vs plain from the resumed state, n_q 2, the '
            f'discriminator\'s coin {coin}: loss relative diffs {rel["loss"]}; gradient '
            f'relative norm diffs {rel["grad"]}; update relative norm diffs {rel["update"]}; '
            f'the kernel step under torch.profiler: wall {prof_ms:.1f} ms, device busy '
            f'{busy:.1f} ms, idle share {1 - busy / prof_ms:.3f}')
        check(all(v <= TRAIN_LOSS_REL for v in rel['loss'].values())
              and all(v <= TRAIN_GRAD_REL for v in rel['grad'])
              and all(v <= TRAIN_UPDATE_REL for v in rel['update'])
              and len(rel['grad']) == (2 if coin else 1) and m_k['disc_updated'] == float(coin)
              and (coin or rel['update'][1] == 0.0),
              f'the kernel step disagrees with the plain step (coin {coin})')
        if coin:
            out.update(busy_ms=busy, idle=1 - busy / prof_ms)

    testset = resumed.testset
    ref_dir, deg_dir = tmp / 'metrics' / 'ref', tmp / 'metrics' / 'deg'
    segments = np.stack([testset[i] for i in range(MONO_NQ2_SEGMENTS)])
    check(len({s['audio_path'] for s in testset.fixed_segments[:MONO_NQ2_SEGMENTS]})
          == MONO_NQ2_SEGMENTS, 'the fixed validation segments are not 16 distinct ones')
    model = resumed.model.eval()
    model.set_target_bandwidth(1.5)
    for fn in entries.values():
        fn.launches = 0
    t0 = time.perf_counter()
    with torch.no_grad():
        frames = model.encode(torch.from_numpy(segments).cuda())
        decoded = model.decode(frames)[..., :segments.shape[-1]].cpu().numpy()
    for i in range(MONO_NQ2_SEGMENTS):
        write_wav(ref_dir / f'seg{i:02d}.wav', segments[i], SR)
        write_wav(deg_dir / f'seg{i:02d}_bw1.5.wav', decoded[i], SR)
    means = cal_metrics.main(['-r', str(ref_dir), '-d', str(deg_dir), '-s', str(SR),
                              '-o', str(tmp / 'metrics' / 'scores.txt'), '--device', 'cuda'])
    torch.cuda.synchronize()
    decode_launches = {k: entries[k].launches for k in names}
    codes = frames[0][0]                  # [B, K, T']
    log(f'mono nq2: {MONO_NQ2_SEGMENTS} fixed validation segments (1 s each) encoded and decoded '
        f'at 1.5 kbps (codes {list(codes.shape)}) and scored by cal_metrics --device cuda in '
        f'{time.perf_counter() - t0:.2f} s: means ' + json.dumps(
            {k: round(v, 4) for k, v in means.items()}) + ' (seeded weights after 6 steps: '
        f'reported, no bar); kernel launches {decode_launches}')
    ref, deg = segments[0, 0], decoded[0, 0]
    card, cpu = (metrics.mel_distance(ref, deg, SR, device=d) for d in ('cuda', 'cpu'))
    log(f'mono nq2: mel_distance of segment 0 on the card {card:.7f}, on the CPU {cpu:.7f} '
        f'(relative {abs(card - cpu) / abs(cpu):.2e})')
    check(codes.shape[1] == 2 and np.isfinite(decoded).all()
          and decoded.shape == segments.shape, 'the decode is not n_q 2 or not finite')
    check(set(means) >= {'stoi', 'si_snr', 'mel_dist'}
          and all(np.isfinite(v) for v in means.values()), f'bad metric means {means}')
    check(abs(card - cpu) <= MEL_CARD_REL * abs(cpu), 'mel_distance on the card disagrees')
    check(all(decode_launches[k] > 0 for k in CODEC_KERNELS),
          f'the decode did not go through K1, K2 and K3: {decode_launches}')
    out.update(metrics=means, launches={k: launches[k] + decode_launches[k] for k in names})
    return out


def write_seeded_lm(torch, seed: int, path: Path, n_q: int):
    """A full-width entropy LM (card 1024, dim 200, 8 heads, 5 layers) with
    torch's default init drawn from ``seed``, as a reference-layout ``.th``."""
    from encodec_pytorch_tpu_torch.models.lm import LMModel
    torch.manual_seed(seed)
    lm = LMModel(n_q=n_q, card=1024, dim=200, num_heads=8, num_layers=5)
    torch.save(lm.state_dict(), path)


@contextlib.contextmanager
def count_host_coders():
    """Count the host route's CDF builds by the C++ coder and by the Python one."""
    from encodec_pytorch_tpu_torch.bitstream import ac, native
    counts = {'native': 0, 'python': 0}
    saved = native.build_cdf_batch, ac.build_stable_quantized_cdf

    def count(name, fn):
        def wrapped(*args, **kwargs):
            counts[name] += 1
            return fn(*args, **kwargs)
        return wrapped

    native.build_cdf_batch = count('native', saved[0])
    ac.build_stable_quantized_cdf = count('python', saved[1])
    try:
        yield counts
    finally:
        native.build_cdf_batch, ac.build_stable_quantized_cdf = saved


@contextlib.contextmanager
def no_host_sync(torch):
    """Raise on any synchronizing CUDA call inside the block."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('error')
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode('default')


def header_bytes(data: bytes) -> int:
    """The size of an ``.ecdc`` container header with its JSON metadata."""
    return 9 + struct.unpack('!I', data[5:9])[0]


def read_lm_frames(data: bytes, K: int, lengths, decode):
    """(header, codes of each frame) of an LM ``.ecdc`` with one unscaled
    frame or several length-prefixed scaled ones; ``decode(payload, K, T)``."""
    from encodec_pytorch_tpu_torch.bitstream.binary import read_ecdc_header
    fo = io.BytesIO(data)
    meta = read_ecdc_header(fo)
    frames = []
    for T in lengths:
        if len(lengths) > 1:
            struct.unpack('!f', fo.read(4))
            n, = struct.unpack('!I', fo.read(4))
            frames.append(decode(fo.read(n), K, T))
        else:
            frames.append(decode(fo.read(), K, T))
    check(fo.read() == b'', 'bytes left after the last frame')
    return meta, frames


def lm_codec_phase(torch, seed, tmp: Path, before=None):
    """LM entropy coding at full width: ``cli -l`` on a 10 s clip at 6 kbps
    through each route (the on-device coder, ``--lm_host`` on the card,
    ``--lm_backend torch``), then the LM on the card against the CPU, no
    host sync inside the step loops, and K6 against its plain version and
    the host coder at the main path's pdfs, timed (with ``before``: beside
    the other checkout's K6, in turns), also at K 32. Returns K6's summary
    and the kernels' launches of the fused route."""
    from encodec_pytorch_tpu_torch import cli
    from encodec_pytorch_tpu_torch import compress as C
    from encodec_pytorch_tpu_torch.bitstream import fused, native
    from encodec_pytorch_tpu_torch.bitstream.binary import read_ecdc_header
    from encodec_pytorch_tpu_torch.models.model import encodec_model_24khz
    from encodec_pytorch_tpu_torch.ops import lm_coder_kernel as k6
    from encodec_pytorch_tpu_torch.utils import read_wav, write_wav

    ckpt, lm_ckpt = tmp / CKPT, tmp / LM24
    write_seeded_lm(torch, seed + 60, lm_ckpt, n_q=32)
    wav_in = tmp / 'lm_in.wav'
    write_wav(wav_in, make_clip(seed + 61, batch=1)[0], SR)
    common = ['-m', 'encodec_24khz', '-c', str(ckpt), '--device', 'cuda', '-f']
    cli.main([str(wav_in), str(tmp / 'lm_packed.ecdc'), '-b', '6', *common])
    cli.main([str(tmp / 'lm_packed.ecdc'), str(tmp / 'lm_packed.wav'), *common])
    packed = (tmp / 'lm_packed.ecdc').read_bytes()
    want, _ = read_wav(tmp / 'lm_packed.wav')
    model = encodec_model_24khz(checkpoint=ckpt, device='cuda')
    model.set_target_bandwidth(6.)
    fo = io.BytesIO(packed)
    meta = read_ecdc_header(fo)
    codes = C._decompress_frame_packed(model, fo, meta['nc'], meta['fr']).astype(np.int64)
    K, T = codes.shape
    check(native.available(), 'the native coder did not build (g++)')
    wav, _ = read_wav(wav_in)

    fused_launches = None
    lms = {}
    for route, extra in (('fused', []), ('host', ['--lm_host']),
                         ('torch', ['--lm_backend', 'torch'])):
        ecdc, out = tmp / f'lm_{route}.ecdc', tmp / f'lm_{route}.wav'
        lm_args = ['--lm_checkpoint', str(lm_ckpt), *extra]
        reset_counts()
        k6.lm_coder.launches = 0
        with count_host_coders() as coders:
            t0 = time.perf_counter()
            cli.main([str(wav_in), str(ecdc), '-b', '6', '-l', *lm_args, *common])
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            cli.main([str(ecdc), str(out), *lm_args, *common])
            torch.cuda.synchronize()
            t2 = time.perf_counter()
        launches = dict(read_counts(), lm_coder=k6.lm_coder.launches)
        if route == 'fused':
            fused_launches = launches
        lm = C.get_lm_model(model, lm_ckpt, device='cpu' if route == 'torch' else 'cuda')
        lms[route] = lm
        data = ecdc.read_bytes()
        if route == 'fused':
            decode = lm.fused_coder.decode
        else:
            def decode(payload, K, T, lm=lm):
                return C._decompress_frame_lm(lm, io.BytesIO(payload), K, T)
        meta, frames = read_lm_frames(data, K, [T], decode)
        got, _ = read_wav(out)
        log(f'LM {route}: CLI compress {t1 - t0:.2f} s, decompress {t2 - t1:.2f} s (model and '
            f'LM loads included); header {meta}; {len(data)} bytes against packed '
            f'{len(packed)}; kernel launches {launches}; host CDF builds {coders}')
        check(meta['lm'] is True and meta['nc'] == K and meta['fr'] == T
              and meta.get('lmv') == C.stream_lmv(lm, route == 'fused')
              and (meta.get('lmv') is None) == (route == 'torch'), f'bad LM header {meta}')
        check(np.array_equal(frames[0], codes), f'LM {route}: codes differ from the packed ones')
        check(np.array_equal(got, want), f'LM {route}: the decoded wav differs from the no-LM one')
        check(all(launches[k] > 0 for k in CODEC_KERNELS),
              f'LM {route}: the codec did not run K1, K2 and K3: {launches}')
        if route == 'fused':
            check(launches['lm_coder'] > 0 and coders['native'] == coders['python'] == 0,
                  f'the on-device route did not run K6 alone: {launches}, {coders}')
        else:
            check(launches['lm_coder'] == 0 and coders['native'] > 0 and coders['python'] == 0,
                  f'the host route did not run the native coder: {launches}, {coders}')
        # API times, warm: compress and decompress without the loads
        fused_route = route == 'fused'
        times = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            again = C.compress(model, wav, use_lm=True, lm=lm, lm_fused=fused_route)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            dec, _ = C.decompress(model, again, lm=lm)
            torch.cuda.synchronize()
            times.append((t1 - t0, time.perf_counter() - t1))
        tc, td = min(t for t, _ in times), min(t for _, t in times)
        log(f'LM {route}: compress {tc * 1e3:.1f} ms (RTF {SECONDS / tc:.2f}), decompress '
            f'{td * 1e3:.1f} ms (RTF {SECONDS / td:.2f}), best of 2 after the CLI run; the '
            f'stream again equal to the CLI\'s: {again == data}; payload '
            f'{len(data) - header_bytes(data)} bytes against packed '
            f'{len(packed) - header_bytes(packed)}, '
            f'{8 * (len(data) - header_bytes(data)) / (K * T):.3f} bits a code')
        check(again == data, f'LM {route}: a second compress wrote other bytes')

    # the LM on the card against the CPU
    p_gpu = lms['fused'].probas_teacher_forced(codes[None])
    p_cpu = lms['torch'].probas_teacher_forced(codes[None])
    cdf_gpu = native.build_cdf_batch(p_gpu[0].transpose(2, 1, 0).reshape(-1, 1024))
    cdf_cpu = native.build_cdf_batch(p_cpu[0].transpose(2, 1, 0).reshape(-1, 1024))
    diff = cdf_gpu != cdf_cpu
    log(f'LM card vs CPU: max |p| difference {np.abs(p_gpu - p_cpu).max():.3e}; CDF entries '
        f'that differ {diff.mean():.6f}, CDF rows with any difference {diff.any(1).mean():.6f} '
        f'(of {diff.shape[0]})')

    # no host sync inside the step loops
    lm = lms['fused']
    coder = lm.fused_coder
    inputs = torch.zeros(T, K, dtype=torch.int64, device='cuda')
    inputs[1:] = 1 + torch.from_numpy(codes.T[:-1]).cuda()
    syms = torch.from_numpy(np.ascontiguousarray(codes.T, np.int32)).cuda()
    bits = torch.zeros(k6.stream_bytes(k6.bits_capacity(K * T)), dtype=torch.uint8, device='cuda')
    tf_inputs = inputs.t()[None].contiguous()
    with no_host_sync(torch):
        coder.encode_steps(inputs, syms, bits)
        out, _ = coder.decode_steps(bits.clone(), 8 * bits.numel(), K, T)
        lm.teacher_forced(tf_inputs)
    check(torch.equal(out.t().cpu(), torch.from_numpy(codes).int()),
          'the sync-checked decode differs')
    log('no host sync inside the step loops: fused encode, fused decode and the host '
        "route's teacher-forced chain ran under set_sync_debug_mode('error')")

    # timing the step loop's parts
    w = coder.weights
    pdfs = torch.empty(T, K, 1024, device='cuda')

    def lm_steps():
        state = fused.kv_init_state(w)
        for t in range(T):
            p, state = fused.kv_lm_step(w, inputs[t], state)
            pdfs[t].copy_(p)

    step_ms = cuda_ms(torch, lm_steps, runs=3, warmup=1) / T
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    coder.decode_steps(bits.clone(), 8 * bits.numel(), K, T)
    torch.cuda.synchronize()
    decode_step_ms = (time.perf_counter() - t0) * 1e3 / T
    pdfs_host = pdfs.cpu().numpy()

    def encode(pd, dev):
        coder_state = k6.init_state(dev)
        buf = torch.zeros(k6.stream_bytes(k6.bits_capacity(K * T)), dtype=torch.uint8, device=dev)
        k6.lm_coder(pd, syms.to(dev), coder_state, buf, decode=False, finish=True)
        n = int(coder_state[k6.BIT_POS])
        return buf[:k6.stream_bytes(n)].cpu().numpy().tobytes(), n

    stream, n_bits = encode(pdfs, 'cuda')
    enc_native = native.NativeAcEncoder(24)
    enc_native.push_batch(codes.T.reshape(-1), native.build_cdf_batch(pdfs_host.reshape(-1, 1024)))
    host_stream = enc_native.finish()
    raw = np.zeros(k6.stream_bytes(k6.bits_capacity(K * T)), np.uint8)
    raw[:len(stream)] = np.frombuffer(stream, np.uint8)
    bits_in = torch.from_numpy(raw).cuda()

    steps_pdfs = pdfs.split(1)      # each step's [1, K, card] view, as the codec has them

    def decode_all(fn, steps):
        coder_state = k6.init_state('cuda')
        out = torch.zeros(steps, K, dtype=torch.int32, device='cuda')
        b = bits_in.clone()
        for t, row in enumerate(out.split(1)):
            fn(steps_pdfs[t], row, coder_state, b, decode=True, n_bits_in=8 * len(stream))
        return out, coder_state

    out, st = decode_all(k6.lm_coder, T)
    check(torch.equal(out.cpu(), syms.cpu()) and int(st[k6.OVERRUN]) == 0,
          'K6 decode of its own stream differs')
    t_plain = time.perf_counter()
    plain_out, _ = decode_all(k6.lm_coder_reference, 24)
    plain_decode_ms = (time.perf_counter() - t_plain) * 1e3 / 24
    check(torch.equal(plain_out.cpu(), syms[:24].cpu()), 'the plain decode differs')
    t_plain = time.perf_counter()
    coder_state = k6.init_state('cuda')
    buf = torch.zeros_like(bits_in)
    k6.lm_coder_reference(pdfs, syms, coder_state, buf, decode=False, finish=True)
    plain_encode_ms = (time.perf_counter() - t_plain) * 1e3
    plain_stream = buf[:k6.stream_bytes(int(coder_state[k6.BIT_POS]))].cpu().numpy().tobytes()
    cdf_k = k6.build_cdf(pdfs).long()
    cdf_p = k6.build_cdf_reference(pdfs)
    err = int((cdf_k - cdf_p).abs().max())
    cdf_host = native.build_cdf_batch(pdfs_host.reshape(-1, 1024))
    check(err == 0 and np.array_equal(cdf_k.reshape(-1, 1024).cpu().numpy(), cdf_host),
          f'K6 CDFs differ from the plain and host builds (max {err})')
    check(stream == plain_stream == host_stream,
          f'K6 bytes differ: kernel {len(stream)}, plain {len(plain_stream)}, '
          f'host {len(host_stream)}')

    fns = {'new': k6.lm_coder}
    if before is not None:
        fns['before'] = before.lm_coder_kernel.lm_coder
        old, _ = decode_all(fns['before'], T)
        check(torch.equal(old.cpu(), syms.cpu()), 'the earlier K6 decodes other symbols')
    dec = timed_turns(torch, {k: (lambda f=f: decode_all(f, T)) for k, f in fns.items()},
                      runs=3, warmup=1, per=T, device_runs=1)
    host = {k: host_ms(torch, lambda f=f: decode_all(f, T), T) for k, f in fns.items()}
    # the encode of all T steps in one call, each on a fresh state and a
    # zeroed buffer taken from a ring (no copy in the timing)
    enc_ring = FreshRing(24, k6.init_state('cuda'), torch.zeros_like(bits_in))
    enc = timed_turns(torch, {k: (lambda f=f: f(pdfs, syms, *enc_ring.take(), False, 0, True))
                              for k, f in fns.items()}, runs=5, warmup=1, refresh=enc_ring.refresh)
    floor = timed_turns(torch, {'new': lambda: k6.lm_coder_floor(1, K, 1024)}, runs=50, warmup=5)
    # the CDF mode over the T steps' pdfs (the checks' build)
    builds = {'new': k6.build_cdf}
    if before is not None:
        builds['before'] = before.lm_coder_kernel.build_cdf
        check(torch.equal(builds['before'](pdfs), cdf_k.int()),
              'the earlier K6 builds other CDFs')
    cdf_t = timed_turns(torch, {k: (lambda f=f: f(pdfs)) for k, f in builds.items()}, runs=5,
                        warmup=1)
    bits_step = n_bits / T
    step_bytes = K * 1024 * 4 + K * 4 + 2 * 8 * k6.STATE_SIZE + bits_step / 8
    b_ms, b_by = bound_ms(7 * K * 1024, step_bytes)
    enc_b_ms, enc_b_by = bound_ms(7 * K * 1024 * T, T * step_bytes)
    log(f'K6 (K {K}, card 1024, T {T}): bytes equal kernel = plain = host coder ({len(stream)} B, '
        f'{bits_step:.2f} bits a step); CDFs equal (max |d| {err}); decode a step: '
        f'{fmt_turns(dec, "us", 1e3)} ({T} launches); host ms a call queued without a sync '
        f'{host}; an empty launch of the decode configuration {fmt_turns(floor, "us", 1e3)}; '
        f'plain {plain_decode_ms:.3f} ms, bound {b_ms * 1e3:.4f} us ({b_by}); encode of all {T} '
        f'steps in one call {fmt_turns(enc)}, plain {plain_encode_ms:.1f} ms, bound '
        f'{enc_b_ms:.5f} ms ({enc_b_by}); CDF mode over the {T} steps {fmt_turns(cdf_t)}')
    k32 = k6_k32_lines(torch, k6, fns, coder, T)
    log(f'LM step on the card (kv_lm_step, {K} codebooks): {step_ms:.4f} ms; fused decode '
        f'{decode_step_ms:.4f} ms a step (LM step + K6, host clock)')
    summary = dict(max_abs_err=float(err), ms=dec['ms'], device_ms=dec['device_ms'],
                   plain_ms=plain_decode_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                   shape=[1, K, 1024], host_ms=host['new'], floor_device_ms=floor['device_ms'],
                   encode_ms=enc['ms'], encode_device_ms=enc['device_ms'],
                   encode_plain_ms=plain_encode_ms, encode_bound_ms=enc_b_ms, k32=k32, cdf=cdf_t,
                   lm_step_ms=step_ms, fused_decode_step_ms=decode_step_ms)
    if before is not None:
        summary.update(before_ms=dec['before_ms'], before_device_ms=dec['before_device_ms'],
                       before_host_ms=host['before'], encode_before_ms=enc['before_ms'],
                       encode_before_device_ms=enc['before_device_ms'])
    return summary, fused_launches


def k6_k32_lines(torch, k6, fns: dict, coder, T: int) -> dict:
    """K6 at 24 kbps' K 32 (card 1024, T steps): pdfs from the seeded LM's
    step on seeded codes, the encode of the T steps in one call against the
    host coder's bytes, the decode a launch a step back to the codes, then
    both timed (each call in ``fns``, in turns) by CUDA events and on the
    device."""
    from encodec_pytorch_tpu_torch.bitstream import fused, native
    K = 32
    rng = np.random.default_rng(3232)
    codes = rng.integers(0, 1024, (T, K))
    inputs = torch.zeros(T, K, dtype=torch.int64, device='cuda')
    inputs[1:] = 1 + torch.from_numpy(codes[:-1]).cuda()
    pdfs = torch.empty(T, K, 1024, device='cuda')
    state = fused.kv_init_state(coder.weights)
    for t in range(T):
        p, state = fused.kv_lm_step(coder.weights, inputs[t], state)
        pdfs[t].copy_(p)
    syms = torch.from_numpy(codes.astype(np.int32)).cuda()
    cap = k6.stream_bytes(k6.bits_capacity(K * T))
    enc = native.NativeAcEncoder(24)
    enc.push_batch(codes.reshape(-1), native.build_cdf_batch(pdfs.cpu().numpy().reshape(-1, 1024)))
    host_stream = enc.finish()
    out = {}
    for name, fn in fns.items():
        st, buf = k6.init_state('cuda'), torch.zeros(cap, dtype=torch.uint8, device='cuda')
        fn(pdfs, syms, st, buf, decode=False, finish=True)
        got = buf[:k6.stream_bytes(int(st[k6.BIT_POS]))].cpu().numpy().tobytes()
        check(got == host_stream, f'K6 ({name}) at K 32: bytes differ from the host coder\'s')
    raw = np.zeros(cap, np.uint8)
    raw[:len(host_stream)] = np.frombuffer(host_stream, np.uint8)
    bits_in = torch.from_numpy(raw).cuda()

    steps_pdfs = pdfs.split(1)

    def decode_all(fn):
        st = k6.init_state('cuda')
        o = torch.zeros(T, K, dtype=torch.int32, device='cuda')
        for t, row in enumerate(o.split(1)):
            fn(steps_pdfs[t], row, st, bits_in, decode=True, n_bits_in=8 * len(host_stream))
        return o

    for name, fn in fns.items():
        check(torch.equal(decode_all(fn).cpu(), syms.cpu()),
              f'K6 ({name}) at K 32: the decode differs from the codes')
    dec = timed_turns(torch, {k: (lambda f=f: decode_all(f)) for k, f in fns.items()}, runs=3,
                      warmup=1, per=T, device_runs=1)
    ring = FreshRing(24, k6.init_state('cuda'), torch.zeros(cap, dtype=torch.uint8,
                                                            device='cuda'))
    encode = timed_turns(torch, {k: (lambda f=f: f(pdfs, syms, *ring.take(), False, 0, True))
                                 for k, f in fns.items()}, runs=5, warmup=1,
                         refresh=ring.refresh)
    b_ms, b_by = bound_ms(7 * K * 1024, K * 1024 * 4 + K * 4 + 128)
    log(f'K6 at K 32 (card 1024, T {T}, {8 * len(host_stream) / T:.2f} bits a step): bytes '
        f'equal the host coder\'s, decode exact; decode a step {fmt_turns(dec, "us", 1e3)}; '
        f'encode of all {T} steps in one call {fmt_turns(encode)}; bound {b_ms * 1e3:.4f} us a '
        f'step ({b_by})')
    return dict(decode=dec, encode=encode, bound_ms=b_ms, bytes=len(host_stream))


def k6_decode_steps(torch, k6, fn, pdfs, payload: bytes):
    """Decode ``payload`` against ``pdfs [T, K, card]`` on the card, one call
    of ``fn`` (K6 or its plain version) a step, as the on-device decoder
    does → (symbols ``[T, K]``, the coder's state after each step ``[T, 8]``)."""
    T, K, _ = pdfs.shape
    buf = np.zeros(k6.stream_bytes(k6.bits_capacity(K * T)), np.uint8)
    raw = np.frombuffer(payload, np.uint8)[:buf.size]
    buf[:raw.size] = raw
    bits = torch.from_numpy(buf).cuda()
    state = k6.init_state('cuda')
    syms = torch.zeros(T, K, dtype=torch.int32, device='cuda')
    states = []
    for t in range(T):
        fn(pdfs[t:t + 1], syms[t:t + 1], state, bits, decode=True, n_bits_in=8 * len(payload))
        states.append(state.clone())
    return syms.cpu(), torch.stack(states).cpu()


def lm48_phase(torch, seed, tmp: Path):
    """A 3 s 48 kHz stereo clip at 6 kbps through ``cli -q -l`` (the
    on-device coder, length-prefixed frames): codes exact, the wav equal to
    the no-LM run's; each frame coded again with K6's plain version gives
    the CLI's bytes, and the first frame decoded a step at a time by K6 and
    by its plain version gives the same symbols and coder states. Returns
    the kernels' launches and the largest state difference."""
    from encodec_pytorch_tpu_torch import cli
    from encodec_pytorch_tpu_torch import compress as C
    from encodec_pytorch_tpu_torch.bitstream import fused
    from encodec_pytorch_tpu_torch.models.model import encodec_model_48khz
    from encodec_pytorch_tpu_torch.ops import lm_coder_kernel as k6
    from encodec_pytorch_tpu_torch.utils import read_wav, write_wav

    ckpt, lm_ckpt = tmp / CKPT48, tmp / LM48
    write_seeded_lm(torch, seed + 70, lm_ckpt, n_q=16)
    wav_in = tmp / 'lm48_in.wav'
    write_wav(wav_in, make_clip(seed + 71, 1, 3, SR48, 2)[0], SR48)
    common = ['-q', '-c', str(ckpt), '--device', 'cuda', '-f', '-b', '6']
    cli.main([str(wav_in), str(tmp / 'lm48_packed.wav'), *common])
    want, _ = read_wav(tmp / 'lm48_packed.wav')
    reset_counts()
    k6.lm_coder.launches = 0
    t0 = time.perf_counter()
    cli.main([str(wav_in), str(tmp / 'lm48.ecdc'), '-l', '--lm_checkpoint', str(lm_ckpt), *common])
    cli.main([str(tmp / 'lm48.ecdc'), str(tmp / 'lm48.wav'), '--lm_checkpoint', str(lm_ckpt),
              *common])
    torch.cuda.synchronize()
    launches = dict(read_counts(), lm_coder=k6.lm_coder.launches)
    model = encodec_model_48khz(checkpoint=ckpt, device='cuda')
    model.set_target_bandwidth(6.)
    wav, _ = read_wav(wav_in)
    enc = model.encode(torch.from_numpy(wav[None]).cuda())
    lm = C.get_lm_model(model, lm_ckpt, device='cuda')
    data = (tmp / 'lm48.ecdc').read_bytes()
    payloads = []

    def decode(payload, K, T):
        payloads.append(payload)
        return lm.fused_coder.decode(payload, K, T)

    meta, frames = read_lm_frames(data, 4, [c.shape[2] for c, _ in enc], decode)
    got, _ = read_wav(tmp / 'lm48.wav')
    log(f'LM 48 kHz: CLI -q -l compress + decompress of 3 s stereo in '
        f'{time.perf_counter() - t0:.2f} s; header {meta}; {len(frames)} length-prefixed '
        f'frames of {[f.shape[1] for f in frames]} steps, {len(data)} bytes; kernel launches '
        f'{launches}')
    check(meta['lmv'] == C.stream_lmv(lm, True) and meta['nc'] == 4
          and len(frames) == len(enc) > 1, f'bad 48 kHz LM stream {meta}')
    check(all(np.array_equal(f, c[0].cpu().numpy()) for f, (c, _) in zip(frames, enc)),
          '48 kHz LM codes differ from the encode')
    check(np.array_equal(got, want), '48 kHz LM decode differs from the no-LM one')
    check(launches['lm_coder'] > 0 and launches['rvq_encode'] > 0
          and launches['lstm_recurrence'] > 0, f'48 kHz LM launches {launches}')

    with plain_path():      # K6 -> its plain version, on the same pdfs
        plain = [lm.fused_coder.encode(c[0].cpu().numpy()) for c, _ in enc]
    check(plain == payloads, '48 kHz: the plain coder wrote other frame bytes than the CLI: '
          f'{[len(p) for p in plain]} against {[len(p) for p in payloads]}')
    codes = frames[0]
    K, T = codes.shape
    w = lm.fused_coder.weights
    inputs = torch.zeros(T, K, dtype=torch.int64, device='cuda')
    inputs[1:] = 1 + torch.from_numpy(codes.T[:-1]).cuda()
    pdfs = torch.empty(T, K, w.card, device='cuda')
    state = fused.kv_init_state(w)
    for t in range(T):
        p, state = fused.kv_lm_step(w, inputs[t], state)
        pdfs[t].copy_(p)
    syms_k, states_k = k6_decode_steps(torch, k6, k6.lm_coder, pdfs, payloads[0])
    syms_p, states_p = k6_decode_steps(torch, k6, k6.lm_coder_reference, pdfs, payloads[0])
    err = int((states_k - states_p).abs().max())
    log(f'K6 at 48 kHz (K {K}, card {w.card}, T {T}): the frame bytes of the plain coder equal '
        f"the CLI's ({[len(p) for p in plain]} B); a step-by-step decode of frame 0 by K6 and "
        f'by the plain version: symbols equal {torch.equal(syms_k, syms_p)}, max |state '
        f'difference| {err} over {T} steps')
    check(torch.equal(syms_k, syms_p) and np.array_equal(syms_k.t().numpy(), codes) and err == 0,
          '48 kHz: K6 and its plain version decode frame 0 differently')
    return launches, err



# the trained entropy LM (phases 6d-6g) and the remaining conv norms (6h)
LM_TRAIN_CLIPS = 64              # 8 steps an epoch at the CLI's batch of 8
LM_TRAIN_CLIP_SECONDS = 3.2      # longer than the CLI's 72000-sample crops
LM_TRAIN_BUDGET_S = 40.0         # the training's time: its epochs are fitted to it
FRAME_MS = 1e3 / 75              # one 24 kHz frame: 13.33 ms
LM_HELD_OUT = 'lm_held_out.wav'
LM_TRAINED = 'lm_trained.msgpack'


def tone_clip(rng, seconds: float, sr: int = SR) -> np.ndarray:
    """The tone mixture of ``scripts/demo_lm_gain.py``: a note from five and
    its octave, under an amplitude modulation of 1-4 Hz, plus a little noise;
    ``[1, T]`` f32 from a ``np.random.RandomState``."""
    t = np.arange(int(sr * seconds)) / sr
    f0 = rng.choice([110., 165., 220., 330., 440.])
    wav = 0.4 * np.sin(2 * np.pi * f0 * t)
    wav += 0.2 * np.sin(2 * np.pi * 2 * f0 * t + rng.uniform(0, np.pi))
    wav *= 0.6 + 0.4 * np.sin(2 * np.pi * rng.uniform(1., 4.) * t)
    wav += 0.01 * rng.randn(t.size)
    return wav.astype(np.float32)[None]


@contextlib.contextmanager
def timed_methods(torch, cls, names, into: dict):
    """Host ms of each call of ``cls``'s methods ``names``, from a
    synchronize before to one after, appended to ``into[name]``."""
    saved = {name: getattr(cls, name) for name in names}

    def timed(name, fn):
        def wrapped(self, *args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(self, *args, **kwargs)
            torch.cuda.synchronize()
            into.setdefault(name, []).append(1e3 * (time.perf_counter() - t0))
            return out
        return wrapped

    for name, fn in saved.items():
        setattr(cls, name, timed(name, fn))
    try:
        yield into
    finally:
        for name, fn in saved.items():
            setattr(cls, name, fn)


def lm_train_phase(torch, seed, tmp: Path) -> dict:
    """Phase 6d: ``lm_train_cli`` in process at its defaults on phase 3's
    seeded codec at 6 kbps. Returns the trained LM's path and the phase's
    numbers."""
    import logging

    from encodec_pytorch_tpu_torch import lm_train_cli
    from encodec_pytorch_tpu_torch.config import Config
    from encodec_pytorch_tpu_torch.data.dataset import CustomAudioDataset, DataLoader
    from encodec_pytorch_tpu_torch.models.model import encodec_model_24khz
    from encodec_pytorch_tpu_torch.train import lm_trainer
    from encodec_pytorch_tpu_torch.utils import write_wav

    rng = np.random.RandomState(seed + 70)
    paths = [tmp / f'lm_train_{i}.wav' for i in range(LM_TRAIN_CLIPS)]
    for path in paths:
        write_wav(path, tone_clip(rng, LM_TRAIN_CLIP_SECONDS), SR)
    csv = tmp / 'lm_train.csv'
    csv.write_text(''.join(f'{p}\n' for p in paths))
    ckpt, out = tmp / CKPT, tmp / LM_TRAINED

    # the epochs that fit the budget, from a probe trainer's steps on the
    # CLI's loader (reading the wavs, encoding, the LM step)
    codec = encodec_model_24khz(checkpoint=ckpt, device='cuda')
    codec.set_target_bandwidth(6.)
    probe = lm_trainer.LMTrainer(codec)
    ds = CustomAudioDataset(Config({
        'datasets': {'train_csv_path': str(csv), 'test_csv_path': str(csv), 'tensor_cut': 72000,
                     'fixed_length': 0}, 'model': {'sample_rate': SR, 'channels': 1}}))
    loader = DataLoader(ds, 8, fixed_length=72000)
    steps_per_epoch = len(loader)
    for i, batch in enumerate(loader):
        if i == 2:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        probe.train_step(probe.codes_for(batch))
    torch.cuda.synchronize()
    probe_ms = (time.perf_counter() - t0) * 1e3 / (steps_per_epoch - 2)
    epochs = max(2, int(LM_TRAIN_BUDGET_S * 1e3 / (probe_ms * steps_per_epoch)))
    del probe, codec

    times = {}
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    logging.disable(logging.INFO)       # the CLI's per-step lines
    t0 = time.perf_counter()
    try:
        with timed_methods(torch, lm_trainer.LMTrainer, ('codes_for', 'train_step'), times):
            trainer = lm_train_cli.main([
                '--codec', 'encodec_24khz', '--codec_checkpoint', str(ckpt), '--bandwidth', '6',
                '--train_csv', str(csv), '--epochs', str(epochs), '--out', str(out),
                '--device', 'cuda'])
    finally:
        logging.disable(logging.NOTSET)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    bits = [float(h['bits_per_code']) for h in trainer.history]
    lm = trainer.lm
    loaded = lm_trainer.load_lm_checkpoint(out, device='cuda')
    same = all(torch.equal(v, loaded.state_dict()[k]) for k, v in lm.state_dict().items())
    summary = dict(steps=trainer.step, epochs=epochs, probe_step_ms=probe_ms, train_s=train_s,
                   bits_first=bits[0], bits_last=bits[-1],
                   lm_step_ms=statistics.median(times['train_step']),
                   encode_ms=statistics.median(times['codes_for']), peak_gb=peak_gb,
                   bytes=out.stat().st_size)
    log(f'LM training (lm_train_cli at its defaults: dim 200, 5 layers, 8 heads, past_context '
        f'{lm.past_context}, batch 8 x 72000, lr 3e-4; codec encodec_24khz seeded, 6 kbps, '
        f'n_q {lm.n_q}; {LM_TRAIN_CLIPS} tone clips): {trainer.step} steps in {epochs} epochs, '
        f'{train_s:.1f} s (probe {probe_ms:.1f} ms a step); bits a code first {bits[0]:.3f}, '
        f'last {bits[-1]:.3f} (packed 10); LM step (forward, backward, Adam) median '
        f'{summary["lm_step_ms"]:.2f} ms, codec encode median {summary["encode_ms"]:.2f} ms a '
        f'batch (host clock, synchronized); peak {peak_gb:.2f} GB; K1-K3 launches {launches}; '
        f'{out.name} {summary["bytes"]} bytes, reloaded bit-equal {same}')
    check(all(launches[k] > 0 for k in CODEC_KERNELS),
          f'LM training did not run K1, K2 and K3: {launches}')
    check(np.isfinite(bits).all() and bits[-1] < bits[0], f'LM training did not learn: {bits}')
    check(same, 'the .msgpack did not reload to the trained parameters')
    return dict(summary, path=out, launches=launches)


def trained_lm_cli_phase(torch, seed, tmp: Path, lm_path: Path) -> dict:
    """Phase 6e: the trained LM through ``cli -l --lm_checkpoint`` on a
    held-out 10 s tone clip, on the on-device route and on ``--lm_host``.
    Returns the clip's codes, the streams' sizes and K6's launches."""
    from encodec_pytorch_tpu_torch import cli
    from encodec_pytorch_tpu_torch import compress as C
    from encodec_pytorch_tpu_torch.bitstream.binary import read_ecdc_header
    from encodec_pytorch_tpu_torch.models.model import encodec_model_24khz
    from encodec_pytorch_tpu_torch.ops import lm_coder_kernel as k6
    from encodec_pytorch_tpu_torch.utils import read_wav, write_wav

    ckpt, wav_in = tmp / CKPT, tmp / LM_HELD_OUT
    write_wav(wav_in, tone_clip(np.random.RandomState(seed + 71), SECONDS), SR)
    common = ['-m', 'encodec_24khz', '-c', str(ckpt), '-b', '6', '--device', 'cuda', '-f']
    cli.main([str(wav_in), str(tmp / 'held_packed.ecdc'), *common])
    cli.main([str(tmp / 'held_packed.ecdc'), str(tmp / 'held_packed.wav'), *common])
    packed = (tmp / 'held_packed.ecdc').read_bytes()
    want, _ = read_wav(tmp / 'held_packed.wav')
    model = encodec_model_24khz(checkpoint=ckpt, device='cuda')
    model.set_target_bandwidth(6.)
    fo = io.BytesIO(packed)
    meta = read_ecdc_header(fo)
    codes = C._decompress_frame_packed(model, fo, meta['nc'], meta['fr']).astype(np.int64)
    K, T = codes.shape
    out = dict(codes=codes, packed=len(packed) - header_bytes(packed), lm_coder=0)
    for route, extra in (('fused', []), ('host', ['--lm_host'])):
        ecdc, wav_out = tmp / f'held_{route}.ecdc', tmp / f'held_{route}.wav'
        lm_args = ['--lm_checkpoint', str(lm_path), *extra]
        reset_counts()
        k6.lm_coder.launches = 0
        t0 = time.perf_counter()
        cli.main([str(wav_in), str(ecdc), '-l', *lm_args, *common])
        cli.main([str(ecdc), str(wav_out), *lm_args, *common])
        torch.cuda.synchronize()
        launches = dict(read_counts(), lm_coder=k6.lm_coder.launches)
        lm = C.get_lm_model(model, lm_path, device='cuda')
        data = ecdc.read_bytes()
        if route == 'fused':
            decode = lm.fused_coder.decode
        else:
            def decode(payload, K, T, lm=lm):
                return C._decompress_frame_lm(lm, io.BytesIO(payload), K, T)
        meta, frames = read_lm_frames(data, K, [T], decode)
        got, _ = read_wav(wav_out)
        payload = len(data) - header_bytes(data)
        out[route] = payload
        log(f'trained LM, cli -l {route} on the held-out {SECONDS} s tone clip: '
            f'{time.perf_counter() - t0:.2f} s (loads included); payload {payload} bytes against '
            f'packed {out["packed"]} ({payload / out["packed"]:.4f}), '
            f'{8 * payload / (K * T):.3f} bits a code against 10; codes equal to the packed '
            f"stream's {np.array_equal(frames[0], codes)}; wav equal to the no-LM run's "
            f'{np.array_equal(got, want)}; launches {launches}')
        check(np.array_equal(frames[0], codes), f'trained LM {route}: codes differ')
        check(np.array_equal(got, want), f'trained LM {route}: the wav differs from the no-LM one')
        check(payload < out['packed'], f'trained LM {route}: the LM stream is not smaller '
              f'({payload} against {out["packed"]} bytes)')
        if route == 'fused':
            check(launches['lm_coder'] > 0, f'the on-device route did not run K6: {launches}')
            out['lm_coder'] = launches['lm_coder']
    return out


def lm_stream_phase(torch, seed, lm_path: Path, codes: np.ndarray, before=None) -> dict:
    """Phase 6f: the streaming LM coder on the card with the trained LM, the
    held-out clip's frames pushed one at a time and the bytes delivered in
    seeded bursts. Returns K6's stall mode's summary and launches (with
    ``before``, its calls also timed in the other checkout's K6, in
    turns)."""
    from encodec_pytorch_tpu_torch.bitstream import fused
    from encodec_pytorch_tpu_torch.ops import lm_coder_kernel as k6
    from encodec_pytorch_tpu_torch.train.lm_trainer import load_lm_checkpoint

    lm = load_lm_checkpoint(lm_path, device='cuda')
    K, T = codes.shape
    one_shot = fused.FusedLmCoder(lm).encode(codes)
    frames = torch.from_numpy(codes.astype(np.int32)).cuda()

    def run(seed_, times=None, record=None):
        def recording(pdfs, syms, state, bits, decode, n_bits_in=0, finish=False, stall=False):
            if stall:
                before = (pdfs.clone(), syms.clone(), state.clone(), bits.clone(), n_bits_in)
            k6.lm_coder(pdfs, syms, state, bits, decode, n_bits_in, finish, stall)
            if stall:
                record.append(before + (syms.clone(), state.clone()))

        if record is not None:     # the coder's view of K6, with its calls recorded
            fused.K6 = types.SimpleNamespace(**dict(vars(k6), lm_coder=recording))
        try:
            enc, dec = fused.StreamingLmEncoder(lm, K), fused.StreamingLmDecoder(lm, K)
            first_buffer = dec._bits.numel()
            rng = np.random.default_rng(seed_)
            sent, wire, decoded, stalls = b'', b'', [], 0

            def pull():
                t0 = time.perf_counter()
                frame = dec.pull_frame()
                if times is not None:
                    times['stalled' if frame is None else 'pull'].append(
                        1e3 * (time.perf_counter() - t0))
                return frame

            for t in range(T):
                t0 = time.perf_counter()
                data = enc.push_frame(frames[:, t])
                if times is not None:
                    times['push'].append(1e3 * (time.perf_counter() - t0))
                sent += data
                wire += data
                n = int(rng.integers(0, len(wire) + 1))
                dec.push_bytes(wire[:n])
                wire = wire[n:]
                while len(decoded) < T:
                    frame = pull()
                    if frame is None:
                        stalls += 1
                        break
                    decoded.append(frame)
            tail = enc.flush()
            dec.push_bytes(wire + tail)
            while len(decoded) < T:
                frame = pull()
                check(frame is not None, f'the decoder stalled after the flush at {len(decoded)}')
                decoded.append(frame)
        finally:
            fused.K6 = k6
        return np.stack(decoded, axis=1), stalls, sent + tail, (first_buffer, dec._bits.numel())

    k6.lm_coder.launches = k6.lm_coder.stall_launches = 0
    record = []
    got, stalls, stream, buffers = run(seed + 72, record=record)
    launches = k6.lm_coder.stall_launches
    check(np.array_equal(got, codes), 'the streamed frames differ from the codes')
    check(stalls > 0, 'the delivery never made the decoder stall')
    check(stream == one_shot, f'the streamed bytes ({len(stream)}) differ from '
          f'FusedLmCoder.encode\'s ({len(one_shot)})')
    # the decoder's buffer starts at one frame's bits: the stream outgrew it,
    # and it ended smaller than the stream, so read bytes were dropped
    check(buffers[0] < len(stream) and buffers[1] < len(stream),
          f'the decoder\'s buffer was never rebased (buffer {buffers} B, stream {len(stream)} B)')
    # K6's stall mode against its plain version on every recorded call
    diff = {'symbols': 0, 'stalls': 0, 'state': 0}
    for pdfs, syms, state, bits, n, syms_k, state_k in record:
        syms_p, state_p = syms.clone(), state.clone()
        k6.lm_coder_reference(pdfs, syms_p, state_p, bits.clone(), decode=True, n_bits_in=n,
                              stall=True)
        diff['symbols'] += int(not torch.equal(syms_p, syms_k))
        diff['stalls'] += int(state_p[k6.STALLED] != state_k[k6.STALLED])
        diff['state'] = max(diff['state'], int((state_p - state_k).abs().max()))
    stalled = sum(int(r[-1][k6.STALLED]) for r in record)
    times = {'push': [], 'pull': [], 'stalled': []}
    run(seed + 73, times=times)
    pct = {k: (_pct(v, 0.5), _pct(v, 0.99)) for k, v in times.items() if v}
    syncs = stream_syncs(torch, fused, lm, frames[:, :SYNC_FRAMES])
    # a call that decodes and one that stalls, each launch on its own copy of
    # the state from a ring (no copy in the timing), by events and on the
    # device; the state copy alone beside them
    fns = {'new': k6.lm_coder}
    if before is not None:
        fns['before'] = before.lm_coder_kernel.lm_coder
    timed = {}
    for label, want in (('decodes', 0), ('stalls', 1)):
        pdfs, syms, state, bits, n, _, _ = next(r for r in record if r[-1][k6.STALLED] == want)
        ring = FreshRing(160, state)
        timed[label] = timed_turns(
            torch, {k: (lambda f=f: f(pdfs, syms, *ring.take(), bits, True, n, False, True))
                    for k, f in fns.items()}, runs=50, warmup=5, refresh=ring.refresh)
    st = state.clone()
    copy = timed_turns(torch, {'new': lambda: st.copy_(state)}, runs=50, warmup=5)
    # push_frame's encode of a frame and the flush, each on a fresh state and
    # zeroed buffer from a ring, after a check that they write the plain
    # version's bytes and state
    pdfs, _, _, _, _, frame, _ = next(r for r in record if not r[-1][k6.STALLED])
    cap = k6.stream_bytes(k6.bits_capacity(K))
    short = {}
    for label, steps, finish in (('push', 1, False), ('flush', 0, True)):
        start = k6.init_state()
        if finish:
            k6.lm_coder_reference(pdfs.cpu(), frame.cpu(), start,
                                  torch.zeros(cap, dtype=torch.uint8), False)
        want_state, want_bits = start.clone(), torch.zeros(cap, dtype=torch.uint8)
        k6.lm_coder_reference(pdfs[:steps].cpu(), frame[:steps].cpu(), want_state, want_bits,
                              False, finish=finish)
        for name, f in fns.items():
            got_state, got_bits = start.cuda(), torch.zeros(cap, dtype=torch.uint8, device='cuda')
            f(pdfs[:steps], frame[:steps], got_state, got_bits, False, 0, finish)
            check(torch.equal(got_state.cpu(), want_state)
                  and torch.equal(got_bits.cpu(), want_bits),
                  f'K6 ({name}): the streaming {label} differs from the plain version')
        ring = FreshRing(160, start.cuda(), torch.zeros(cap, dtype=torch.uint8, device='cuda'))
        short[label] = timed_turns(
            torch, {k: (lambda f=f, n=steps, e=finish: f(pdfs[:n], frame[:n], *ring.take(), False,
                                                          0, e)) for k, f in fns.items()},
            runs=50, warmup=5, refresh=ring.refresh)
    pdfs, syms, state, bits, n, _, _ = next(r for r in record if not r[-1][k6.STALLED])
    t0 = time.perf_counter()
    for _ in range(10):
        k6.lm_coder_reference(pdfs, syms.clone(), state.clone(), bits.clone(), decode=True,
                              n_bits_in=n, stall=True)
    plain_ms = (time.perf_counter() - t0) * 1e2
    bits_frame = 8 * len(stream) / T
    b_ms, b_by = bound_ms(7 * K * lm.card,
                          K * lm.card * 4 + K * 4 + 2 * 8 * k6.STATE_SIZE + bits_frame / 8)
    log(f'streaming LM coder (trained LM, K {K}, {T} frames, bursty delivery): frames exact, '
        f'{stalls} stalls; bytes equal FusedLmCoder.encode\'s ({len(stream)} B); the decoder\'s '
        f'buffer {buffers[0]} B at the start, {buffers[1]} B at the end (rebased); K6 stall-mode '
        f'calls {len(record)} ({stalled} stalled) against its plain version on the same inputs: '
        f'symbols differing {diff["symbols"]}, stall decisions differing {diff["stalls"]}, max '
        f'|state difference| {diff["state"]}; stall-mode launches in the run {launches}')
    log('streaming LM coder, host ms a call (p50, p99) beside the '
        f'{FRAME_MS:.2f} ms frame period: ' + ', '.join(
            f'{k} {a:.3f} / {b:.3f} ({len(times[k])} calls)' for k, (a, b) in pct.items()))
    log(f'streaming LM coder, synchronizing calls torch flags a call over {SYNC_FRAMES} frames '
        "(set_sync_debug_mode('warn')): " + ', '.join(
            f'{k} {sorted(set(v))} ({len(v)} calls)' for k, v in syncs.items()))
    check(all(set(syncs[k]) == {1} for k in ('push_frame', 'pull_frame'))
          and set(syncs['push_bytes']) == {0},
          f'the streaming coder does not sync the host once a frame: {syncs}')
    log(f'K6 stall mode (one frame, K {K}, card {lm.card}), a call on a state from a ring: one '
        f'that decodes {fmt_turns(timed["decodes"], "us", 1e3)}; one that stalls '
        f'{fmt_turns(timed["stalls"], "us", 1e3)}; the state copy alone '
        f'{fmt_turns(copy, "us", 1e3)}; plain {plain_ms:.3f} ms, bound {b_ms * 1e3:.4f} us '
        f'({b_by}); push_frame\'s encode of a frame {fmt_turns(short["push"], "us", 1e3)}; the '
        f'flush {fmt_turns(short["flush"], "us", 1e3)} (bytes and state equal the plain '
        'version\'s)')
    check(diff == {'symbols': 0, 'stalls': 0, 'state': 0} and stalled > 0,
          f'K6 stall mode and its plain version differ: {diff}')
    check(launches > 0, 'the streaming decoder did not run K6 in its stall mode')
    summary = dict(
        max_abs_err=float(diff['state']), ms=timed['decodes']['ms'],
        device_ms=timed['decodes']['device_ms'], plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=None, shape=[1, K, lm.card], stalled_call=timed['stalls'],
        copy_device_ms=copy['device_ms'], push_encode=short['push'], flush=short['flush'],
        calls=len(record), stalled_calls=stalled,
        stalls=stalls, push_ms=pct['push'], pull_ms=pct['pull'],
        stalled_pull_ms=pct.get('stalled'), frame_ms=FRAME_MS)
    if before is not None:
        summary.update(before_ms=timed['decodes']['before_ms'],
                       before_device_ms=timed['decodes']['before_device_ms'])
    return dict(launches=launches, summary=summary)


SYNC_FRAMES = 50


def stream_syncs(torch, fused, lm, frames) -> dict:
    """The synchronizing CUDA calls torch's sync debug mode flags in each
    ``push_frame``, ``push_bytes`` and ``pull_frame`` of a stream of
    ``frames [K, T]`` (on the card; every other frame pushed as numpy codes),
    every byte delivered at once."""
    import warnings
    K, T = frames.shape
    host = frames.cpu().numpy()
    enc, dec = fused.StreamingLmEncoder(lm, K), fused.StreamingLmDecoder(lm, K)
    syncs = {'push_frame': [], 'push_bytes': [], 'pull_frame': []}

    def counted(name, fn, *args):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter('always')
            out = fn(*args)
        syncs[name].append(sum('synchroniz' in str(w.message) for w in caught))
        return out

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('warn')
    try:
        pulled = 0
        for t in range(T):
            codes = host[:, t] if t % 2 else frames[:, t]
            counted('push_bytes', dec.push_bytes, counted('push_frame', enc.push_frame, codes))
            while counted('pull_frame', dec.pull_frame) is not None:
                pulled += 1
    finally:
        torch.cuda.set_sync_debug_mode('default')
    check(pulled > 0, 'no frame was pulled in the sync count')
    return syncs


def kv_free_phase(torch, lm_path: Path, codes: np.ndarray) -> dict:
    """Phase 6g: ``FusedLmCoder(kv_cache=False)`` (the LM module's own step)
    round-trips the held-out clip's 10 s of codes on the card, timed beside
    the projected-KV coder. Returns K6's launches."""
    from encodec_pytorch_tpu_torch.bitstream import fused
    from encodec_pytorch_tpu_torch.ops import lm_coder_kernel as k6
    from encodec_pytorch_tpu_torch.train.lm_trainer import load_lm_checkpoint

    lm = load_lm_checkpoint(lm_path, device='cuda')
    K, T = codes.shape
    out = {}
    for kv in (False, True):
        coder = fused.FusedLmCoder(lm, kv_cache=kv)
        k6.lm_coder.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        data = coder.encode(codes)
        t1 = time.perf_counter()
        got = coder.decode(data, K, T)
        t2 = time.perf_counter()
        out[kv] = dict(encode_ms=1e3 * (t1 - t0), decode_ms=1e3 * (t2 - t1), bytes=len(data),
                       launches=k6.lm_coder.launches, exact=bool(np.array_equal(got, codes)))
    log(f'FusedLmCoder(kv_cache=False) on the card ({SECONDS} s, K {K}, T {T}, trained LM): '
        f'encode {out[False]["encode_ms"]:.1f} ms, decode {out[False]["decode_ms"]:.1f} ms '
        f'({out[False]["decode_ms"] / T:.3f} ms a step), {out[False]["bytes"]} bytes, exact '
        f'{out[False]["exact"]}, K6 launches {out[False]["launches"]}; kv_cache=True: encode '
        f'{out[True]["encode_ms"]:.1f} ms, decode {out[True]["decode_ms"]:.1f} ms '
        f'({out[True]["decode_ms"] / T:.3f} ms a step), {out[True]["bytes"]} bytes')
    check(out[False]['exact'] and out[True]['exact'], 'a fused coder did not round-trip')
    check(out[False]['launches'] > 0, 'the kv_cache=False coder did not run K6')
    return dict(lm_coder=out[False]['launches'], times=out)


def conv_norms_phase(torch, seed) -> dict:
    """Phase 6h: seeded full-width 24 kHz models with ``layer_norm`` and
    ``spectral_norm`` convs, 10 s encoded and decoded at 6 kbps through the
    kernels and through their plain versions. Returns the launches."""
    from encodec_pytorch_tpu_torch.models.model import EncodecModel

    clip = torch.from_numpy(make_clip(seed + 80, batch=1)).cuda()
    total = dict.fromkeys(CODEC_KERNELS, 0)
    for norm in ('layer_norm', 'spectral_norm'):
        model = EncodecModel._get_model(
            [1.5, 3., 6, 12., 24.], SR, 1, causal=True, model_norm=norm, name='encodec_24khz',
            generator=torch.Generator().manual_seed(seed + 81)).cuda().eval()
        fit_codebooks(torch, model, seed + 82)
        model.set_target_bandwidth(6.)
        with torch.no_grad():
            reset_counts()
            t0 = time.perf_counter()
            frames = model.encode(clip)
            wav = model.decode(frames)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            launches = read_counts()
            with plain_path():
                plain_frames = model.encode(clip)
                plain_wav = model.decode(plain_frames)
        same = float((frames[0][0] == plain_frames[0][0]).float().mean())
        snr = snr_db(plain_wav.cpu().numpy(), wav.cpu().numpy())
        log(f'conv norm {norm} (seeded full-width encodec_24khz, {SECONDS} s at 6 kbps): encode + '
            f'decode {ms:.1f} ms; kernel path against plain: codes equal {same:.6f}, decode SNR '
            f'{snr:.2f} dB; launches {launches}')
        check(same >= 0.99 and snr >= SNR_MIN_DB, f'{norm}: kernel and plain paths disagree')
        check(launches['rvq_encode'] > 0 and launches['lstm_recurrence'] > 0,
              f'{norm}: K1 and K2 not launched: {launches}')
        if norm == 'layer_norm':       # an output norm: the blocks are conv sequences
            check(launches['resblock'] == 0, f'layer_norm blocks ran K3: {launches}')
        else:                          # a weight norm: K3 on the materialised weights
            check(launches['resblock'] > 0, f'spectral_norm blocks did not run K3: {launches}')
        for k in CODEC_KERNELS:
            total[k] += launches[k]
    return total


def bf16_ulps(torch, got, ref):
    """Per element, |got - ref| in units of the bf16 spacing at the larger of
    the two magnitudes (bf16 keeps 8 significant bits)."""
    a, b = got.float(), ref.float()
    mag = torch.maximum(a.abs(), b.abs()).clamp_min(2.0 ** -126)
    return (a - b).abs() / torch.exp2(torch.floor(torch.log2(mag)) - 7)


def bf16_agreement(torch, got, ref) -> dict:
    """A bf16 kernel's output against its plain version's: the share of
    bit-equal elements, the largest difference in bf16 ulps, how many differ
    by more than 1 ulp, how many of those also differ by more than 1e-5 of
    max|ref| (the f32 sums' own spread; ``bad``), and max |d|."""
    ulps = bf16_ulps(torch, got, ref)
    d = (got.float() - ref.float()).abs()
    top = float(ref.float().abs().max())
    over = ulps > 1
    return dict(equal=float((got.view(torch.int16) == ref.view(torch.int16)).float().mean()),
                max_ulps=float(ulps.max()), over_1ulp=int(over.sum()),
                bad=int((over & (d > K4_TOL_REL * top)).sum()), max_abs=float(d.max()),
                top=top)


def fmt_agree(a: dict) -> str:
    return (f"bit-equal {a['equal']:.6f}, max {a['max_ulps']:.1f} ulps, {a['over_1ulp']} over "
            f"1 ulp ({a['bad']} of them above 1e-5 of max), max |d| {a['max_abs']:.3e} of max "
            f"{a['top']:.3e}")


def bf16_ok(a: dict) -> bool:
    return a['equal'] >= BF16_EQUAL_SHARE and a['bad'] == 0


def record_disc_convs(torch, config, seed: int, clip_seed: int, want):
    """The discriminator of ``config`` on a batch of its shape: the input, the
    weight and the bias (in the compute dtype) and the module of every conv
    for which ``want(module)`` holds, in call order."""
    from encodec_pytorch_tpu_torch.train.trainer import build_disc_from_config
    disc = build_disc_from_config(config, 'cuda', torch.Generator().manual_seed(seed))
    B, length = int(config.datasets.batch_size), int(config.datasets.tensor_cut)
    sr, channels = int(config.model.sample_rate), int(config.model.channels)
    calls = []

    def record(module, args):
        d = module.dtype
        calls.append((args[0].detach().to(d), module.conv.kernel().detach().to(d),
                      module.conv.bias.detach().to(d), module))

    hooks = [m.register_forward_pre_hook(record) for m in disc.modules() if want(m)]
    with torch.no_grad():
        disc(torch.from_numpy(make_clip(clip_seed, B, length / sr, sr, channels)).cuda())
    for h in hooks:
        h.remove()
    return calls


def k4_bf16_phase(torch, seed, before=None):
    """K4's bf16 forward and dx against their plain versions, cuDNN in bf16
    and K4's f32 form at the shapes of one bf16 discriminator call of each
    config: 24 kHz (the default set, bf16): the 12 eligible convs, forward and
    dx; 48 kHz (``tpu.compute_dtype=bfloat16``): conv_4's 3 forwards (K5
    takes conv_1..3's) and the 12 convs' dx. With ``before`` (another
    checkout), its K4 bf16 on the same inputs: its time by events and on the
    device, and the share of outputs bit-equal to it. Returns the forward's
    and the dx's summaries over both calls."""
    import torch.nn.functional as F

    from encodec_pytorch_tpu_torch.config import load_config
    from encodec_pytorch_tpu_torch.ops import disc_conv_kernel as dck

    keys = ('ms', 'device_ms', 'kernel_ms', 'plain_ms', 'library_ms', 'f32_ms', 'bound_ms',
            'gflop') + (('before_ms', 'before_device_ms') if before is not None else ())
    tot = {p: {k: 0.0 for k in keys} for p in ('fwd', 'dx')}
    worst = {'fwd': 0.0, 'dx': 0.0}
    equal_before = {'fwd': [], 'dx': []}
    shapes = {'fwd': [], 'dx': []}
    gen = torch.Generator(device='cuda').manual_seed(seed + 30)
    bdck = before.disc_conv_kernel if before is not None else None
    for name, overrides in (('config', []), ('config_48k_stereo', ['tpu.compute_dtype=bfloat16'])):
        config = load_config(overrides, name=name)
        calls = record_disc_convs(
            torch, config, seed, seed + 31,
            lambda m: getattr(m, 'uses_kernel', False) or getattr(m, 'uses_im2col', False))
        check(len(calls) == 12 and all(x.dtype == torch.bfloat16 for x, *_ in calls),
              f'expected 12 eligible bf16 convs at {name}, found {len(calls)}')
        for x, w, b, m in calls:
            geo = (m.stride, m.dilation, m.padding)
            K = w.shape[1] * w.shape[2] * w.shape[3]
            y_ref = dck.disc_conv_forward_reference(x, w, b, *geo)
            flops = 2.0 * y_ref.numel() * K
            g = torch.randn(y_ref.shape, generator=gen, device='cuda').to(torch.bfloat16)
            passes = (('fwd',) if m.uses_kernel else ()) + ('dx',)
            for p in passes:
                if p == 'fwd':
                    run = lambda: dck.disc_conv_forward_bf16(x, w, b, *geo)
                    got, ref = run(), y_ref
                    # the conv alone, and the bias added after its rounding
                    conv = dck.disc_conv_forward_bf16(x, w, None, *geo)
                    agree = bf16_agreement(torch, conv,
                                           dck.disc_conv_forward_reference(x, w, None, *geo))
                    epilogue = bool(torch.equal(got, conv + b.reshape(1, -1, 1, 1)))
                    wk = dck.pack_weight_cuda(w, m.stride[1], dx=False)
                    packed = torch.equal(wk, dck.pack_weight_bf16(w.permute(1, 2, 3, 0)[None],
                                                                  m.stride[1]))
                    kern = lambda: dck.forward_packed(x, wk, b, w.shape, *geo)
                    plain = lambda: dck.disc_conv_forward_reference(x, w, b, *geo)
                    lib = lambda: F.conv2d(x, w, b, stride=m.stride, padding=m.padding,
                                           dilation=m.dilation)
                    x32, w32, b32 = x.float(), w.float(), b.float()
                    f32 = lambda: dck.disc_conv_forward(x32, w32, b32, *geo)
                    parent = ((lambda: bdck.disc_conv_forward_bf16(x, w, b, *geo))
                              if bdck else None)
                    nbytes = 2.0 * (x.numel() + w.numel() + b.numel() + y_ref.numel())
                else:
                    run = lambda: dck.disc_conv_input_grad_bf16(g, w, x.shape, *geo)
                    got = run()
                    ref = dck.disc_conv_input_grad_reference(g, w, x.shape, *geo)
                    agree, epilogue = bf16_agreement(torch, got, ref), True
                    wk = dck.pack_weight_cuda(w, m.stride[1], dx=True)
                    packed = torch.equal(wk, dck.pack_weight_bf16(dck.pack_dx_weight(w,
                                                                                     m.stride[1]),
                                                                  1))
                    kern = lambda: dck.input_grad_packed(g, wk, w.shape, x.shape, *geo)
                    plain = lambda: dck.disc_conv_input_grad_reference(g, w, x.shape, *geo)
                    lib = lambda: torch.nn.grad.conv2d_input(x.shape, w, g, stride=m.stride,
                                                             padding=m.padding,
                                                             dilation=m.dilation)
                    g32, w32 = g.float(), w.float()
                    f32 = lambda: dck.disc_conv_input_grad(g32, w32, x.shape, *geo)
                    parent = ((lambda: bdck.disc_conv_input_grad_bf16(g, w, x.shape, *geo))
                              if bdck else None)
                    nbytes = 2.0 * (g.numel() + w.numel() + x.numel())
                again = bool(torch.equal(got, run()))
                whole = bf16_agreement(torch, got, ref)
                row = dict(config=name, x=list(x.shape), dilation=list(m.dilation),
                           stride=list(m.stride))
                if parent is not None:   # in turns: parent, this tree, this tree, parent
                    ms = [cuda_ms(torch, f) for f in (parent, run, run, parent)]
                    row['ms'], row['before_ms'] = (ms[1] + ms[2]) / 2, (ms[0] + ms[3]) / 2
                    row['before_device_ms'] = device_ms(torch, parent)
                    row['equal_before'] = float((parent().view(torch.int16)
                                                 == got.view(torch.int16)).float().mean())
                    equal_before[p].append(row['equal_before'])
                else:
                    row['ms'] = cuda_ms(torch, run)
                row['device_ms'] = device_ms(torch, run)
                row['kernel_ms'] = cuda_ms(torch, kern)
                row['plain_ms'] = cuda_ms(torch, plain)
                row['library_ms'] = cuda_ms(torch, lib)
                row['f32_ms'] = cuda_ms(torch, f32)
                row['bound_ms'], _ = bound_ms(flops, nbytes, PEAK_BF16_FLOPS)
                row['gflop'] = flops / 1e9
                row.update(equal=whole['equal'], conv_max_ulps=agree['max_ulps'],
                           conv_over_1ulp=agree['over_1ulp'])
                log(f'K4 bf16 {p} {name} x {tuple(x.shape)} w {tuple(w.shape)} stride '
                    f'{m.stride} dilation {m.dilation}, {flops / 1e9:.2f} GFLOP: vs plain '
                    f'{fmt_agree(whole)}; the conv{" before the bias" if p == "fwd" else ""} '
                    f'{fmt_agree(agree)}; bias added after the rounding: {epilogue}; packing '
                    f'= plain: {packed}; repeat bit-equal: {again}; wrapper {row["ms"]:.4f} ms '
                    f'(on the device {fmt_ms(row["device_ms"])}; kernel {row["kernel_ms"]:.4f} '
                    f'ms), plain {row["plain_ms"]:.4f} ms, cuDNN bf16 {row["library_ms"]:.4f} '
                    f'ms, K4 f32 {row["f32_ms"]:.4f} ms, bound {row["bound_ms"]:.4f} ms (bf16)'
                    + (f'; the earlier kernel {row["before_ms"]:.4f} ms (on the device '
                       f'{fmt_ms(row["before_device_ms"])}), bit-equal to it '
                       f'{row["equal_before"]:.6f}' if parent is not None else ''))
                check(bf16_ok(agree) and whole['equal'] >= BF16_EQUAL_SHARE and epilogue
                      and packed and again,
                      f'K4 bf16 {p} disagrees with its plain version at x {tuple(x.shape)}')
                worst[p] = max(worst[p], whole['max_abs'])
                for k in keys:
                    tot[p][k] += row[k] if row[k] is not None else float('nan')
                shapes[p].append(row)
                del got, ref
            del y_ref, g
    wide = k4_bf16_wide(torch, seed)
    out = []
    for p in ('fwd', 'dx'):
        t = tot[p]
        log(f'K4 bf16 {p} over both discriminator calls ({len(shapes[p])} convs, '
            f'{t["gflop"]:.1f} GFLOP): wrapper {t["ms"]:.3f} ms (on the device '
            f'{fmt_ms(t["device_ms"])}; kernel {t["kernel_ms"]:.3f} ms), plain '
            f'{t["plain_ms"]:.3f} ms, cuDNN bf16 {t["library_ms"]:.3f} ms, K4 f32 '
            f'{t["f32_ms"]:.3f} ms, bound {t["bound_ms"]:.3f} ms'
            + (f'; the earlier kernel {t["before_ms"]:.3f} ms (on the device '
               f'{fmt_ms(t["before_device_ms"])}), bit-equal to it {min(equal_before[p]):.6f} '
               f'at the worst shape' if before is not None else ''))
        out.append(dict(max_abs_err=worst[p], **{k: v for k, v in t.items() if k != 'gflop'},
                        bound_by='operations', shapes=shapes[p], wide=wide[p]))
    return out


def k4_bf16_wide(torch, seed) -> dict:
    """K4 bf16 where a CTA's weights do not all stay in shared memory, so that
    they stream chunk by chunk beside the input: the 24 kHz discriminator in
    bf16 at ``model.filters=64``, its 12 eligible convs forward and dx, held
    to their plain versions by the bf16 rule (the bias after the rounding
    bit-exact, a repeat bit-equal) and timed beside cuDNN bf16. Returns
    per pass the wrapper's and cuDNN's ms over the 12 convs."""
    import torch.nn.functional as F

    from encodec_pytorch_tpu_torch.config import load_config
    from encodec_pytorch_tpu_torch.ops import disc_conv_kernel as dck
    config = load_config(['model.filters=64'], name='config')
    calls = record_disc_convs(torch, config, seed, seed + 32,
                              lambda m: getattr(m, 'uses_kernel', False))
    check(len(calls) == 12 and all(w.shape[:2] == (64, 64) for _, w, _, _ in calls),
          f'expected 12 eligible 64-channel convs, found {len(calls)}')
    gen = torch.Generator(device='cuda').manual_seed(seed + 33)
    out = {p: dict(ms=0.0, library_ms=0.0, equal=1.0, max_abs_err=0.0) for p in ('fwd', 'dx')}
    for x, w, b, m in calls:
        geo = (m.stride, m.dilation, m.padding)
        conv = dck.disc_conv_forward_bf16(x, w, None, *geo)
        y = dck.disc_conv_forward_bf16(x, w, b, *geo)
        g = torch.randn(y.shape, generator=gen, device='cuda').to(torch.bfloat16)
        dx = dck.disc_conv_input_grad_bf16(g, w, x.shape, *geo)
        results = {
            'fwd': (conv, dck.disc_conv_forward_reference(x, w, None, *geo),
                    torch.equal(y, conv + b.reshape(1, -1, 1, 1))
                    and torch.equal(y, dck.disc_conv_forward_bf16(x, w, b, *geo)),
                    lambda: dck.disc_conv_forward_bf16(x, w, b, *geo),
                    lambda: F.conv2d(x, w, b, stride=m.stride, padding=m.padding,
                                     dilation=m.dilation)),
            'dx': (dx, dck.disc_conv_input_grad_reference(g, w, x.shape, *geo),
                   torch.equal(dx, dck.disc_conv_input_grad_bf16(g, w, x.shape, *geo)),
                   lambda: dck.disc_conv_input_grad_bf16(g, w, x.shape, *geo),
                   lambda: torch.nn.grad.conv2d_input(x.shape, w, g, stride=m.stride,
                                                      padding=m.padding, dilation=m.dilation))}
        for p, (got, ref, exact, run, lib) in results.items():
            agree = bf16_agreement(torch, got, ref)
            ms, lib_ms = cuda_ms(torch, run), cuda_ms(torch, lib)
            log(f'K4 bf16 {p} at 64 channels (weights streamed) x {tuple(x.shape)} dilation '
                f'{m.dilation}: vs plain {fmt_agree(agree)}; bias after the rounding and a '
                f'repeat bit-exact: {exact}; wrapper {ms:.4f} ms, cuDNN bf16 {lib_ms:.4f} ms')
            check(bf16_ok(agree) and exact,
                  f'K4 bf16 {p} at 64 channels disagrees with its plain version at x '
                  f'{tuple(x.shape)}')
            o = out[p]
            o.update(ms=o['ms'] + ms, library_ms=o['library_ms'] + lib_ms,
                     equal=min(o['equal'], agree['equal']),
                     max_abs_err=max(o['max_abs_err'], agree['max_abs']))
        del conv, y, g, dx, results
    for p, o in out.items():
        log(f'K4 bf16 {p} at 64 channels over the 12 convs: wrapper {o["ms"]:.3f} ms, cuDNN '
            f'bf16 {o["library_ms"]:.3f} ms, bit-equal to plain >= {o["equal"]:.6f}')
    return out


def k5_bf16_phase(torch, seed, before=None):
    """K5's bf16 forward against its plain version (the im2col GEMM in f32 on
    the bf16 operands), cuDNN in bf16, K4's bf16 forward and K5's f32 form at
    the 9 F-stride-2 convs of one bf16 discriminator call at the 48 kHz
    config, each conv's bound labelled by what binds it. With ``before``
    (another checkout), its K5 bf16 on the same inputs, in turns (parent,
    this tree, this tree, parent): the wrapper and the kernel alone by CUDA
    events and the wrapper on the device, and this tree's conv before the
    bias held to the parent's by the bf16 rule. Returns the summary over the
    9 convs."""
    import torch.nn.functional as F

    from encodec_pytorch_tpu_torch.config import load_config
    from encodec_pytorch_tpu_torch.ops import disc_conv_kernel as dck
    from encodec_pytorch_tpu_torch.ops import disc_im2col_kernel as k5

    config = load_config(['tpu.compute_dtype=bfloat16'], name='config_48k_stereo')
    calls = record_disc_convs(torch, config, seed, seed + 32,
                              lambda m: getattr(m, 'uses_im2col', False))
    check(len(calls) == 9, f'expected 9 F-stride-2 convs, found {len(calls)}')
    keys = ('ms', 'device_ms', 'kernel_ms', 'plain_ms', 'library_ms', 'k4_ms', 'f32_ms',
            'bound_ms', 'gflop') + (('before_ms', 'before_device_ms', 'before_kernel_ms')
                                    if before is not None else ())
    tot = {k: 0.0 for k in keys}
    bound_by_ms = {'bytes': 0.0, 'operations': 0.0}
    worst = 0.0
    equal_before = []
    shapes = []
    bk5 = before.disc_im2col_kernel if before is not None else None
    for x, w, b, m in calls:
        geo = (m.dilation, m.padding)
        run = lambda: k5.disc_im2col_forward_bf16(x, w, b, *geo)
        y = run()
        ref = k5.disc_im2col_forward_plain(x, w, b, *geo)
        conv = k5.disc_im2col_forward_bf16(x, w, None, *geo)
        agree = bf16_agreement(torch, conv, k5.disc_im2col_forward_plain(x, w, None, *geo))
        whole = bf16_agreement(torch, y, ref)
        epilogue = bool(torch.equal(y, conv + b.reshape(1, -1, 1, 1)))
        k4 = dck.disc_conv_forward_bf16(x, w, b, k5.STRIDE, *geo)
        same_k4 = bf16_agreement(torch, y, k4)
        wk = k5.pack_weight_cuda(w)
        packed = torch.equal(wk, k5.pack_weight_bf16(w))
        again = bool(torch.equal(y, run()))
        x32, w32, b32 = x.float(), w.float(), b.float()
        row = dict(x=list(x.shape), dilation=list(m.dilation))
        kern = lambda: k5.forward_packed(x, wk, b, *geo)
        if bk5 is not None:
            # the conv before the bias against the parent's, by the rule it
            # holds to its plain version
            parent = bf16_agreement(torch, conv, bk5.disc_im2col_forward_bf16(x, w, None, *geo))
            equal_before.append(parent['equal'])
            wk_before = bk5.pack_weight_cuda(w)
            wrapper = timed_turns(torch, {'new': run, 'before': lambda: bk5.disc_im2col_forward_bf16(
                x, w, b, *geo)}, runs=20)
            alone = timed_turns(torch, {'new': kern, 'before': lambda: bk5.forward_packed(
                x, wk_before, b, *geo)}, runs=20)
            row.update(ms=wrapper['ms'], device_ms=wrapper['device_ms'],
                       before_ms=wrapper['before_ms'], before_device_ms=wrapper['before_device_ms'],
                       kernel_ms=alone['ms'], before_kernel_ms=alone['before_ms'],
                       equal_before=parent['equal'])
        else:
            row['ms'] = cuda_ms(torch, run)
            row['device_ms'] = device_ms(torch, run)
            row['kernel_ms'] = cuda_ms(torch, kern)
        row['plain_ms'] = cuda_ms(torch, lambda: k5.disc_im2col_forward_plain(x, w, b, *geo),
                                  runs=5)
        row['library_ms'] = cuda_ms(torch, lambda: F.conv2d(x, w, b, stride=k5.STRIDE,
                                                            padding=m.padding,
                                                            dilation=m.dilation))
        row['k4_ms'] = cuda_ms(torch, lambda: dck.disc_conv_forward_bf16(x, w, b, k5.STRIDE,
                                                                         *geo))
        row['f32_ms'] = cuda_ms(torch, lambda: k5.disc_im2col_forward(x32, w32, b32, *geo))
        flops = 2.0 * y.numel() * w[0].numel()
        row['bound_ms'], row['bound_by'] = bound_ms(
            flops, 2.0 * (x.numel() + w.numel() + b.numel() + y.numel()), PEAK_BF16_FLOPS)
        bound_by_ms[row['bound_by']] += row['bound_ms']
        row['gflop'] = flops / 1e9
        row.update(equal=whole['equal'], conv_max_ulps=agree['max_ulps'],
                   conv_over_1ulp=agree['over_1ulp'], equal_k4=same_k4['equal'])
        log(f'K5 bf16 x {tuple(x.shape)} dilation {m.dilation}, {row["gflop"]:.2f} GFLOP: vs '
            f'plain {fmt_agree(whole)}; the conv before the bias {fmt_agree(agree)}; bias added '
            f'after the rounding: {epilogue}; vs K4 bf16 bit-equal {same_k4["equal"]:.6f}; '
            f'packing = plain: {packed}; repeat bit-equal: {again}; wrapper {row["ms"]:.4f} ms '
            f'(on the device {fmt_ms(row["device_ms"])}; kernel {row["kernel_ms"]:.4f} ms), '
            f'plain {row["plain_ms"]:.4f} ms, cuDNN bf16 {row["library_ms"]:.4f} ms, K4 bf16 '
            f'{row["k4_ms"]:.4f} ms, K5 f32 {row["f32_ms"]:.4f} ms, bound '
            f'{row["bound_ms"]:.4f} ms (bf16, {row["bound_by"]})'
            + (f'; the earlier kernel, in turns: wrapper {row["before_ms"]:.4f} ms (on the '
               f'device {fmt_ms(row["before_device_ms"])}; kernel '
               f'{row["before_kernel_ms"]:.4f} ms), the conv before the bias against it '
               f'{fmt_agree(parent)}'
               if bk5 is not None else ''))
        check(bf16_ok(agree) and whole['equal'] >= BF16_EQUAL_SHARE and epilogue and packed
              and again, f'K5 bf16 disagrees with its plain version at x {tuple(x.shape)}')
        check(bk5 is None or bf16_ok(parent),
              f'K5 bf16 disagrees with the earlier kernel (--before) at x {tuple(x.shape)}')
        worst = max(worst, whole['max_abs'])
        for k in keys:
            tot[k] += row[k] if row[k] is not None else float('nan')
        shapes.append(row)
        del y, ref, conv, k4
    by = max(bound_by_ms, key=bound_by_ms.get)
    log(f'K5 bf16 over one 48 kHz bf16 discriminator call (9 convs, {tot["gflop"]:.1f} GFLOP): '
        f'wrapper {tot["ms"]:.3f} ms (on the device {fmt_ms(tot["device_ms"])}; kernel '
        f'{tot["kernel_ms"]:.3f} ms), plain {tot["plain_ms"]:.3f} ms, cuDNN bf16 '
        f'{tot["library_ms"]:.3f} ms, K4 bf16 forward {tot["k4_ms"]:.3f} ms, K5 f32 '
        f'{tot["f32_ms"]:.3f} ms, bound {tot["bound_ms"]:.3f} ms (bytes bind convs worth '
        f'{bound_by_ms["bytes"]:.3f} ms of it, operations {bound_by_ms["operations"]:.3f} ms)'
        + (f'; the earlier kernel, in turns: wrapper {tot["before_ms"]:.3f} ms (on the device '
           f'{fmt_ms(tot["before_device_ms"])}; kernel {tot["before_kernel_ms"]:.3f} ms), '
           f'bit-equal to it {min(equal_before):.6f} at the worst shape'
           if bk5 is not None else ''))
    return dict(max_abs_err=worst, **{k: v for k, v in tot.items() if k != 'gflop'},
                bound_by=by, shapes=shapes)


BF16_ENTRIES = ('disc_conv_forward_bf16', 'disc_conv_input_grad_bf16', 'disc_im2col_forward_bf16')


def _bf16_entries():
    from encodec_pytorch_tpu_torch.ops import disc_conv_kernel as dck
    from encodec_pytorch_tpu_torch.ops import disc_im2col_kernel as k5
    return {'disc_conv_forward_bf16': dck.disc_conv_forward_bf16,
            'disc_conv_input_grad_bf16': dck.disc_conv_input_grad_bf16,
            'disc_im2col_forward_bf16': k5.disc_im2col_forward_bf16}


def _model_and_disc(torch, config, seed: int, capturable: bool = False):
    """The generator, the discriminator, Adam for each and a balancer of
    ``config`` at full width on the card, from ``seed``."""
    from encodec_pytorch_tpu_torch.train.balancer import Balancer
    from encodec_pytorch_tpu_torch.train.step import make_optimizer
    from encodec_pytorch_tpu_torch.train.trainer import (build_disc_from_config,
                                                         build_model_from_config)
    init = torch.Generator().manual_seed(seed)
    model = build_model_from_config(config, 'cuda', init).train()
    disc = build_disc_from_config(config, 'cuda', init).train()
    return (model, disc, make_optimizer(model.parameters(), capturable),
            make_optimizer(disc.parameters(), capturable),
            Balancer(config.balancer.weights.to_dict()))


def step48_bf16_phase(torch, seed) -> dict:
    """One full-width step of ``config_48k_stereo`` in bf16 (32 x 48000
    stereo): K5 and K4 in bf16, the peak memory; then kernels against plain
    from the state after it. Returns the bf16 kernels' launches in the
    first step."""
    from encodec_pytorch_tpu_torch.config import load_config
    from encodec_pytorch_tpu_torch.train.step import train_step

    config = load_config(['tpu.compute_dtype=bfloat16'], name='config_48k_stereo')
    model, disc, opt_g, opt_d, balancer = _model_and_disc(torch, config, seed)
    sr, B, length = SR48, int(config.datasets.batch_size), int(config.datasets.tensor_cut)
    batch = torch.from_numpy(make_clip(seed + 33, B, length / sr, sr, 2)).cuda()
    n_q = max(model.n_q_for_bandwidth_index())
    entries = _bf16_entries()
    for fn in entries.values():
        fn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    metrics = train_step(model, disc, balancer, opt_g, opt_d, batch, n_q=n_q, train_disc=True,
                         lr_g=3e-4, lr_d=3e-4, sample_rate=sr,
                         generator=torch.Generator(device='cuda').manual_seed(seed))
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 1e9
    launches = {k: fn.launches for k, fn in entries.items()}
    log(f'48 kHz bf16 step: 32 x 2 x 48000, n_q {n_q}, {wall:.1f} ms (the first step: k-means '
        f'init), peak memory {peak:.2f} GB, bf16 kernel launches {launches}, losses '
        + json.dumps({k: round(float(metrics[k]), 6) for k in ('l_t', 'l_f', 'l_g', 'l_feat',
                                                               'loss_w', 'loss_disc')}))
    check(launches['disc_im2col_forward_bf16'] > 0 and launches['disc_conv_forward_bf16'] > 0
          and launches['disc_conv_input_grad_bf16'] > 0,
          f'the 48 kHz bf16 step did not launch K5 and K4 in bf16: {launches}')
    check(all(np.isfinite(float(v)) for v in metrics.values()), 'non-finite 48 kHz bf16 step')
    _, _, rel, prof_ms, prof = kernel_vs_plain_step(torch, model, disc, balancer, opt_g, opt_d,
                                                    batch, n_q, sr, seed + 1)
    busy = busy_ms(torch, prof)
    log(f'48 kHz bf16 step: kernels vs plain from the state after it: loss relative diffs '
        f'{rel["loss"]}; gradient relative norm diffs {rel["grad"]}; update relative norm '
        f'diffs {rel["update"]}; the kernel step under torch.profiler: wall {prof_ms:.1f} ms, '
        f'device busy {busy:.1f} ms, idle share {1 - busy / prof_ms:.3f}')
    check(all(v <= TRAIN_BF16_LOSS_REL for v in rel['loss'].values())
          and all(v <= TRAIN_BF16_GRAD_REL for v in rel['grad'])
          and all(v <= TRAIN_BF16_UPDATE_REL for v in rel['update']),
          'the 48 kHz bf16 kernel step disagrees with the plain step')
    return launches


def _state_tensors(model, disc, opts, balancer):
    """Every tensor of the training state, cloned, in a fixed order."""
    out = [t.detach().clone() for m in (model, disc) for t in m.state_dict().values()]
    for opt in opts:
        for p in opt.param_groups[0]['params']:
            out += [v.detach().clone() for _, v in sorted(opt.state[p].items())]
    out += [balancer.total[k].clone() for k in sorted(balancer.total)]
    out += [balancer.fix[k].clone() for k in sorted(balancer.fix)]
    return out


def accum_guard_phase(torch, seed) -> None:
    """Gradient accumulation at 48 kHz (f32, ``tpu.grad_accum_steps=2``):
    one step's peak memory against one microbatch; then the non-finite guard
    on the 24 kHz default set (bf16) at full width: a NaN batch leaves the
    state bit-equal with ``skipped_nonfinite`` 1, a clean one trains with 0,
    the guard's own cost, and guarded steps under
    ``torch.cuda.set_sync_debug_mode('error')``."""
    from encodec_pytorch_tpu_torch.config import load_config
    from encodec_pytorch_tpu_torch.train.step import NonFiniteGuard, train_step

    config = load_config(name='config_48k_stereo')
    model, disc, opt_g, opt_d, balancer = _model_and_disc(torch, config, seed)
    sr, B, length = SR48, int(config.datasets.batch_size), int(config.datasets.tensor_cut)
    batch = torch.from_numpy(make_clip(seed + 34, B, length / sr, sr, 2)).cuda()
    n_q = max(model.n_q_for_bandwidth_index())
    step = lambda accum: train_step(model, disc, balancer, opt_g, opt_d, batch, n_q=n_q,
                                    train_disc=True, lr_g=3e-4, lr_d=3e-4, sample_rate=sr,
                                    generator=torch.Generator(device='cuda').manual_seed(seed),
                                    grad_accum_steps=accum)
    step(1)                                       # k-means init, outside the measurement
    peaks, walls = {}, {}
    for accum in (1, 2):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        metrics = step(accum)
        torch.cuda.synchronize()
        walls[accum] = 1e3 * (time.perf_counter() - t0)
        peaks[accum] = torch.cuda.max_memory_allocated() / 1e9
        check(all(np.isfinite(float(v)) for v in metrics.values()),
              f'non-finite 48 kHz step at accumulation {accum}')
    log(f'accumulation: config_48k_stereo f32, 32 x 2 x 48000, n_q {n_q}: peak memory '
        f'{peaks[1]:.2f} GB at 1 microbatch, {peaks[2]:.2f} GB at 2 of 16; step '
        f'{walls[1]:.1f} / {walls[2]:.1f} ms')
    check(peaks[2] < peaks[1], 'accumulation did not lower the peak memory')
    del model, disc, opt_g, opt_d, balancer, batch

    config = load_config(['tpu.skip_nonfinite_steps=true'])
    model, disc, opt_g, opt_d, balancer = _model_and_disc(torch, config, seed, capturable=True)
    sr, B, length = SR, int(config.datasets.batch_size), int(config.datasets.tensor_cut)
    clean = [torch.from_numpy(make_clip(seed + 35 + i, B, length / sr, sr)).cuda()
             for i in range(3)]
    bad = torch.full_like(clean[0], float('nan'))
    n_q = max(model.n_q_for_bandwidth_index())
    gen = torch.Generator(device='cuda').manual_seed(seed)

    def guarded(x):
        return train_step(model, disc, balancer, opt_g, opt_d, x, n_q=n_q, train_disc=True,
                          lr_g=3e-4, lr_d=3e-4, sample_rate=sr, generator=gen,
                          skip_nonfinite=True)

    for x in clean[:2]:       # k-means init; the stages' flags are then known on the host
        guarded(x)
    before = _state_tensors(model, disc, (opt_g, opt_d), balancer)
    metrics = guarded(bad)
    after = _state_tensors(model, disc, (opt_g, opt_d), balancer)
    same = all(torch.equal(a, b) for a, b in zip(before, after))
    skipped = float(metrics['skipped_nonfinite'])
    log(f'guard: 24 kHz {model.encoder.dtype} step at full width on a NaN batch: '
        f'skipped_nonfinite {skipped}, the state ({len(before)} tensors) bit-equal: {same}')
    check(skipped == 1.0 and same, 'the guard did not drop the NaN step')
    # the guard's own cost: its copy before a step, its check and selects after
    metrics = guarded(clean[2])
    check(float(metrics['skipped_nonfinite']) == 0.0, 'the guard dropped a clean step')

    device = torch.device('cuda')

    def guard_alone():
        NonFiniteGuard(model, disc, balancer, opt_g, opt_d, device).apply(dict(metrics))

    guard_ms = cuda_ms(torch, guard_alone, runs=10)
    g = NonFiniteGuard(model, disc, balancer, opt_g, opt_d, device)
    copy_gb = sum(t.numel() * t.element_size() for t in g.saved) / 1e9
    del g
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for x in clean:
        guarded(x)
    torch.cuda.synchronize()
    with_guard = 1e3 * (time.perf_counter() - t0) / len(clean)
    t0 = time.perf_counter()
    for x in clean:
        train_step(model, disc, balancer, opt_g, opt_d, x, n_q=n_q, train_disc=True, lr_g=3e-4,
                   lr_d=3e-4, sample_rate=sr, generator=gen)
    torch.cuda.synchronize()
    without = 1e3 * (time.perf_counter() - t0) / len(clean)
    with no_host_sync(torch):
        for x in clean:
            metrics = guarded(x)
    log(f'guard: copy and check-and-select alone {guard_ms:.3f} ms a step by CUDA events, '
        f'{copy_gb:.3f} GB of copies; steps {with_guard:.1f} ms guarded, {without:.1f} ms '
        f'unguarded (host clock, 3 each); {len(clean)} guarded steps ran under '
        f'set_sync_debug_mode("error") with no host sync; skipped_nonfinite '
        f'{float(metrics["skipped_nonfinite"])}')


# data parallelism (phase 20): (a) 2 ranks on the one card over gloo, the
# shipped config at full width (12 rows: 6 a rank) in its bf16 and in f32,
# these steps (n_q, discriminator update): the first runs the k-means init of
# all 32 stages and the dead-code expiry; (b) train_cli as one rank under
# torchrun's environment over NCCL
DP_RANKS = 2
DP_STEPS = ((32, False), (8, True), (16, True))
DP_DTYPES = ('bfloat16', 'float32')
# the 2 ranks against one process on the global batch, relative norm of the
# difference by group of the state and of stage 0's codebook: about 2.3-6x
# the readings, which repeat bit for bit under deterministic algorithms
# (NVIDIA H100 80GB HBM3, 700 W). f32: parameters 1.01e-5, Adam 2.56e-5,
# balancer 9.85e-5, codebook buffers 7.34e-3 (from stages 15-18, which hold
# few codes: their codebooks' norms are near 0), stage 0 1.68e-5. bf16:
# cuDNN's bf16 convs at 6 rows round otherwise than at 12, and the k-means
# (50 iterations, 2700 rows, 1024 bins) turns that into other codes:
# parameters 4.40e-3, Adam 8.78e-2, balancer 0.128, stage 0 1.50e-2, the
# codebook buffers 0.789 (cluster sizes and sums of flipped codes; no bound)
DP_REL = {'bfloat16': {'parameters': 1e-2, 'adam': 0.2, 'balancer': 0.3, 'stage 0': 5e-2},
          'float32': {'parameters': 3e-5, 'adam': 1e-4, 'balancer': 3e-4, 'codebooks': 2e-2,
                      'stage 0': 1e-4}}
DP_TIMEOUT = 600
DP_STATE_GROUPS = ('parameters', 'adam', 'codebooks', 'balancer')


def _dp_group(name: str) -> str:
    if name.startswith('model/quantizer.'):
        return 'codebooks'
    if name.startswith('opt_'):
        return 'adam'
    return 'balancer' if name.startswith('balancer/') else 'parameters'


def _dp_state(model, disc, opts, balancer) -> dict:
    """The training state by name, on the host: parameters and buffers,
    Adam's moments and step counts, the balancer's EMA."""
    out = {f'model/{k}': v for k, v in model.state_dict().items()}
    out.update({f'disc/{k}': v for k, v in disc.state_dict().items()})
    for name, opt, module in (('opt_g', opts[0], model), ('opt_d', opts[1], disc)):
        for pname, p in module.named_parameters():
            out.update({f'{name}/{k}/{pname}': v for k, v in opt.state.get(p, {}).items()})
    for name in ('total', 'fix'):
        out.update({f'balancer/{name}/{k}': v for k, v in getattr(balancer, name).items()})
    return {k: v.detach().cpu().clone() for k, v in out.items()}


def dp_steps(torch, folder: Path, dtype: str, dp=None) -> dict:
    """``DP_STEPS`` of the shipped config at full width in ``dtype`` from
    ``folder``'s seeded global batch, with deterministic algorithms: on the
    whole batch, or under ``dp`` on this rank's rows. Returns the state, each
    step's ms (host clock, ending in a synchronize) and ms in collectives,
    the collectives a step, the metrics and the kernels' launches."""
    from encodec_pytorch_tpu_torch.config import load_config
    from encodec_pytorch_tpu_torch.parallel import assert_replicated
    from encodec_pytorch_tpu_torch.train.step import train_step

    spec = torch.load(folder / 'spec.pt', weights_only=True)
    config = load_config([f'tpu.compute_dtype={dtype}'])
    model, disc, opt_g, opt_d, balancer = _model_and_disc(torch, config, spec['seed'])
    x = spec['batch']
    if dp is not None:
        rows = x.shape[0] // dp.world
        x = x[dp.rank * rows:(dp.rank + 1) * rows]
    x = x.cuda()
    entries = _dp_entries()
    for fn in entries.values():
        fn.launches = 0
    gen = torch.Generator(device='cuda').manual_seed(spec['seed'] + 2)
    ms, coll_ms, colls, metrics = [], [], [], []
    with deterministic(torch):
        for n_q, train_disc in DP_STEPS:
            c0, n0 = (dp.collective_ms(), dp.collectives) if dp is not None else (0.0, 0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = train_step(model, disc, balancer, opt_g, opt_d, x, n_q=n_q,
                           train_disc=train_disc, lr_g=3e-4, lr_d=3e-4, sample_rate=SR,
                           generator=gen, dp=dp)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
            if dp is not None:
                coll_ms.append(dp.collective_ms() - c0)
                colls.append(dp.collectives - n0)
            metrics.append({k: float(v) for k, v in m.items()})
    state = _dp_state(model, disc, (opt_g, opt_d), balancer)
    if dp is not None:
        assert_replicated(dp, list(state.values()))
    expired = int((model.quantizer.vq.layers[0]._codebook.cluster_size < 2).sum())
    return dict(state=state, ms=ms, collective_ms=coll_ms, collectives=colls, metrics=metrics,
                launches={k: fn.launches for k, fn in entries.items()}, expired=expired,
                dtype=str(model.encoder.dtype), rows=int(x.shape[0]))


def _dp_entries() -> dict:
    """The kernels the data-parallel path may launch: K1, K2 and K3 (the
    test loop), K4 in f32 and bf16, K5 bf16 (not in ``config``)."""
    return dict(_all_entries(), **_bf16_entries())


# the kernels each dtype's training step must launch
DP_KERNELS = {'bfloat16': ('disc_conv_forward_bf16', 'disc_conv_input_grad_bf16',
                           'lstm_recurrence'),
              'float32': ('disc_conv_forward', 'disc_conv_input_grad', 'lstm_recurrence')}


def dp_rank_main(rank: int, folder: Path) -> int:
    """A rank of phase 20 (a): joins the gloo group at ``folder``, runs
    :func:`dp_steps` on its rows with its collectives timed, saves the result."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT))
    from encodec_pytorch_tpu_torch.ops import _build
    from encodec_pytorch_tpu_torch.parallel import DataParallel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    _build.load()
    dist.init_process_group('gloo', init_method=f'file://{folder}/rendezvous', rank=rank,
                            world_size=DP_RANKS)
    try:
        dp = DataParallel()
        dp.timed = True
        torch.save({dtype: dp_steps(torch, folder, dtype, dp) for dtype in DP_DTYPES},
                   folder / f'rank{rank}.pt')
    finally:
        dist.destroy_process_group()
    return 0


def data_parallel_phase(torch, seed, tmp: Path, smi: str) -> dict:
    """(a) 2 ranks on the card over gloo against one process on the global
    batch; (b) ``train_cli`` as one rank under torchrun's environment over
    NCCL against the same run without a process group. Returns the kernels'
    launches on the data-parallel path (the ranks' and (b)'s)."""
    import socket

    from encodec_pytorch_tpu_torch import train_cli
    from encodec_pytorch_tpu_torch.config import load_config
    from encodec_pytorch_tpu_torch.train import trainer as trainer_module
    from encodec_pytorch_tpu_torch.train.step import train_step

    config = load_config()
    B, length = int(config.datasets.batch_size), int(config.datasets.tensor_cut)
    folder = tmp / 'ranks'
    folder.mkdir()
    torch.save({'seed': seed, 'batch': torch.from_numpy(make_clip(seed + 70, B, length / SR))},
               folder / 'spec.pt')
    env = dict(os.environ, OMP_NUM_THREADS='4')
    logs = [open(folder / f'rank{r}.log', 'w') for r in range(DP_RANKS)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, str(ROOT / 'chip_smoke.py'), '--dp-rank', str(r),
                               '--dp-dir', str(folder)], env=env, stdout=logs[r],
                              stderr=subprocess.STDOUT) for r in range(DP_RANKS)]
    try:
        codes = [p.wait(timeout=DP_TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    wall = time.perf_counter() - t0
    for r, code in enumerate(codes):
        if code != 0:
            log(f'data parallel: rank {r} failed ({code}); the end of its output:')
            for line in (folder / f'rank{r}.log').read_text().splitlines()[-40:]:
                log(f'  {line}')
    check(codes == [0] * DP_RANKS, f'a rank of the 2-rank run failed: exit codes {codes}')
    results = [torch.load(folder / f'rank{r}.pt', weights_only=True) for r in range(DP_RANKS)]
    launches = {}
    for dtype in DP_DTYPES:
        ranks = [res[dtype] for res in results]
        single = dp_steps(torch, folder, dtype)
        for r, res in enumerate(ranks):
            share = [c / m for c, m in zip(res['collective_ms'], res['ms'])]
            log(f'data parallel (a): rank {r} of {DP_RANKS} on {smi}, gloo (every all-reduce '
                f'staged through the host), {res["rows"]} of {B} rows x {length} in '
                f'{res["dtype"]}, steps (n_q, disc) {list(DP_STEPS)}: ms per step '
                f'{[round(t, 1) for t in res["ms"]]}, in collectives '
                f'{[round(t, 1) for t in res["collective_ms"]]} (CUDA events on the step\'s '
                f'stream; share {[round(x, 3) for x in share]}; {res["collectives"]} '
                f'all-reduces a step); launches {res["launches"]}')
        log(f'data parallel (a): one process on the {B} rows in {single["dtype"]}, the same '
            f'steps: ms per step {[round(t, 1) for t in single["ms"]]}; launches '
            f'{single["launches"]}')
        a, b, want = ranks[0]['state'], ranks[1]['state'], single['state']
        check(a.keys() == b.keys() == want.keys(), 'the ranks\' state differs in its tensors')
        differ = [k for k in a if not torch.equal(a[k], b[k])]
        check(not differ, f'the ranks disagree in {len(differ)} tensors: {differ[:5]}')
        rel = {}
        for g in DP_STATE_GROUPS:
            keys = [k for k in want if _dp_group(k) == g]
            rel[g] = _rel_norm(torch.cat([a[k].reshape(-1).double() for k in keys]),
                               torch.cat([want[k].reshape(-1).double() for k in keys]))
        embed = lambda st, k: st[f'model/quantizer.vq.layers.{k}._codebook.embed'].double()
        stages = [_rel_norm(embed(a, k), embed(want, k)) for k in range(DP_STEPS[0][0])]
        rel['stage 0'] = stages[0]
        losses = {k: (ranks[0]['metrics'][-1][k], single['metrics'][-1][k])
                  for k in ('loss_g', 'loss_w', 'loss_disc', 'l_feat')}
        log(f'data parallel (a), {dtype}: the 2 ranks bit-equal ({len(a)} tensors); against one '
            f'process on the global batch, relative norm of the difference by group {rel} (bars '
            f'{DP_REL[dtype]}), of each stage\'s codebook {[float(f"{x:.3g}") for x in stages]}; '
            f'codes of stage 0 under the expiry threshold after the steps: '
            f'{ranks[0]["expired"]} (one process {single["expired"]}); the last step\'s losses '
            f'(2 ranks, one process) {losses}')
        check(all(rel[g] <= bar for g, bar in DP_REL[dtype].items()),
              f'the 2-rank step in {dtype} left the global batch\'s: {rel}')
        check(ranks[0]['expired'] > 0, 'the steps expired no code')
        check(all(res['launches'][k] > 0 for res in ranks for k in DP_KERNELS[dtype]),
              f'the ranks in {dtype} did not launch {DP_KERNELS[dtype]}')
        for res in ranks:
            for k, v in res['launches'].items():
                launches[k] = launches.get(k, 0) + v
    log(f'data parallel (a): the 2 ranks took {wall:.1f} s from start to exit (start-up and the '
        f'kernels\' load included)')

    # kernels against plain at a rank's shapes (6 rows), from the trained state
    model, disc, opt_g, opt_d, balancer = _model_and_disc(torch, config, seed)
    x6 = torch.from_numpy(make_clip(seed + 71, B // DP_RANKS, length / SR)).cuda()
    gen = torch.Generator(device='cuda').manual_seed(seed)
    train_step(model, disc, balancer, opt_g, opt_d, x6, n_q=8, train_disc=True, lr_g=3e-4,
               lr_d=3e-4, sample_rate=SR, generator=gen)
    _, _, diffs, _, _ = kernel_vs_plain_step(torch, model, disc, balancer, opt_g, opt_d, x6, 8,
                                             SR, seed)
    log(f'data parallel (a): kernels against plain at a rank\'s {B // DP_RANKS} rows, bf16: '
        f'losses {diffs["loss"]}, gradients {diffs["grad"]}, updates {diffs["update"]}')
    check(all(v <= TRAIN_BF16_LOSS_REL for v in diffs['loss'].values())
          and all(v <= TRAIN_BF16_GRAD_REL for v in diffs['grad'])
          and all(v <= TRAIN_BF16_UPDATE_REL for v in diffs['update']),
          'kernels disagree with plain at a rank\'s shapes')
    del model, disc, opt_g, opt_d, balancer

    # (b) train_cli under torchrun's environment, one rank over NCCL, 2 steps
    overrides = train_overrides(tmp, seed, batches=2)
    entries = _dp_entries()
    real_init, real_step = trainer_module.initialize_distributed, trainer_module.train_step
    coll = []

    def timed_init(*args, **kwargs):
        dp = real_init(*args, **kwargs)
        if dp is not None:
            dp.timed = True
        return dp

    def step(*args, dp=None, **kwargs):
        c0 = dp.collective_ms() if dp is not None else 0.0
        out = real_step(*args, dp=dp, **kwargs)
        if dp is not None:
            coll.append(dp.collective_ms() - c0)
        return out

    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        port = s.getsockname()[1]
    launcher = {'RANK': '0', 'WORLD_SIZE': '1', 'LOCAL_RANK': '0', 'MASTER_ADDR': '127.0.0.1',
                'MASTER_PORT': str(port)}
    check(not any(k in os.environ for k in launcher), 'a launcher\'s environment is set already')
    for fn in entries.values():
        fn.launches = 0
    trainer_module.initialize_distributed, trainer_module.train_step = timed_init, step
    try:
        with deterministic(torch):
            plain = train_cli.main(['--device', 'cuda', *overrides,
                                    f'checkpoint.save_folder={tmp}/plain/'])
            os.environ.update(launcher)
            try:
                ranked = train_cli.main(['--device', 'cuda', *overrides,
                                         f'checkpoint.save_folder={tmp}/nccl/'])
            finally:
                for k in launcher:
                    os.environ.pop(k, None)
    finally:
        trainer_module.initialize_distributed, trainer_module.train_step = real_init, real_step
    b_launches = {k: fn.launches for k, fn in entries.items()}
    same = [torch.equal(p, q) for p, q in zip(plain.replicated_tensors(),
                                               ranked.replicated_tensors())]
    steps_ms = [t for h in ranked.history for t in h['step_ms']]
    log(f'data parallel (b): train_cli under torchrun\'s environment (RANK 0, WORLD_SIZE 1) on '
        f'{ranked.device}: process group {ranked.dp.backend if ranked.dp else "none"}, rank '
        f'{ranked.rank} of {ranked.world}; {len(steps_ms)} steps of '
        f'{ranked.config.datasets.batch_size} x {ranked.tensor_cut}, ms per step '
        f'{[round(t, 1) for t in steps_ms]}, in collectives {[round(t, 2) for t in coll]} '
        f'(NCCL, CUDA events on the step\'s stream; share '
        f'{[round(c / t, 4) for c, t in zip(coll, steps_ms)]}); without a process group '
        f'{[round(t, 1) for h in plain.history for t in h["step_ms"]]} ms; state bit-equal in '
        f'{sum(same)} of {len(same)} tensors; launches {b_launches}')
    check(ranked.dp is not None and ranked.dp.backend == 'nccl' and ranked.world == 1
          and plain.dp is None, 'train_cli did not join the launcher\'s NCCL process group')
    check(len(steps_ms) == 2 and len(same) > 0 and all(same),
          'one rank over NCCL is not bit-equal to the run without a process group')
    check(all(b_launches[k] > 0 for k in DP_KERNELS['bfloat16']),
          f'train_cli under the launcher did not launch {DP_KERNELS["bfloat16"]}')
    return {k: launches[k] + b_launches[k] for k in b_launches}


def bf16_codec_phase(torch, seed, ckpt: Path) -> dict:
    """The seeded ``encodec_24khz`` built with ``dtype=bfloat16`` on the 10 s
    clip at 6 kbps against the same weights in f32, with two sets of
    codebooks: the checkpoint's, fitted to the model's own residuals (code
    agreement by stage, the latent's relative error and each stage's residual
    beside it, decode relative RMS and SNR), and random-normal ones, the
    recipe of ``tests/test_bf16.py:52-83``, whose gate (>= 95 % of codes) they
    are held to. Fitted codebooks put codewords at near-equal distances, where
    the latent's bf16 rounding flips the choice; the JAX package's bf16
    pipeline flips as many (``tests/test_torch_bf16.py``), so they are held
    to the decode gate only. K1 and K2 run, K3 does not (bf16 blocks take the
    conv sequence). Returns the launch counts of the bf16 runs."""
    from encodec_pytorch_tpu_torch.models.model import encodec_model_24khz
    clip = torch.from_numpy(make_clip(seed + 3, batch=1)).cuda()
    models = {d: encodec_model_24khz(checkpoint=ckpt, device='cuda', dtype=d)
              for d in (torch.float32, torch.bfloat16)}
    launches = dict.fromkeys(CODEC_KERNELS, 0)

    def run_both():
        out = {}
        for dtype, model in models.items():
            model.set_target_bandwidth(6.)
            reset_counts()
            frames = model.encode(clip)
            wav = model.decode(frames)[:, :, :clip.shape[-1]]
            torch.cuda.synchronize()
            if dtype == torch.bfloat16:
                for k, v in read_counts().items():
                    launches[k] += v
            out[dtype] = (frames[0][0], wav.float().cpu().numpy())
        (c32, w32), (c16, w16) = out[torch.float32], out[torch.bfloat16]
        by_stage = [round(float((c32[:, k] == c16[:, k]).float().mean()), 4)
                    for k in range(c32.shape[1])]
        rel_rms = float(np.sqrt(np.mean((w32 - w16) ** 2)) / np.sqrt(np.mean(w32 ** 2)))
        return float((c32 == c16).float().mean()), by_stage, rel_rms, snr_db(w32, w16), c32

    agree, by_stage, rel_rms, snr, c32 = run_both()
    with torch.no_grad():
        z32, z16 = (m.encoder(clip) for m in models.values())
    embed = models[torch.float32].quantizer.vq.embeds(c32.shape[1])
    residual, res_rel = z32.transpose(1, 2), []
    for k in range(c32.shape[1]):
        res_rel.append(round(float(residual.norm() / z32.norm()), 4))
        residual = residual - embed[k][c32[:, k].long()]
    log(f'bf16 codec: encodec_24khz seeded, 10 s at 6 kbps, dtype bfloat16 against float32, '
        f'the checkpoint\'s fitted codebooks: codes equal {agree:.6f} (by stage {by_stage}); '
        f'the latent\'s relative error {float((z16 - z32).norm() / z32.norm()):.2e}, each '
        f'stage\'s residual relative to the latent {res_rel}; decode relative RMS '
        f'{rel_rms:.4f} (SNR {snr:.2f} dB)')
    check(rel_rms < BF16_DECODE_REL_RMS, 'the bf16 codec decodes beyond the gate of '
          'tests/test_bf16.py')
    gen = torch.Generator(device='cuda').manual_seed(seed + 4)
    with torch.no_grad():
        for k, layer in enumerate(models[torch.float32].quantizer.vq.layers):
            embed = torch.randn(layer._codebook.embed.shape, generator=gen, device='cuda')
            for m in models.values():
                m.quantizer.vq.layers[k]._codebook.embed.copy_(embed)
    agree, by_stage, rel_rms, snr, _ = run_both()
    log(f'bf16 codec: the same with random-normal codebooks (tests/test_bf16.py): codes equal '
        f'{agree:.6f} (by stage {by_stage}); decode relative RMS {rel_rms:.4f} (SNR '
        f'{snr:.2f} dB); launches in the bf16 runs {launches}')
    check(agree >= BF16_CODES_SHARE and rel_rms < BF16_DECODE_REL_RMS,
          'the bf16 codec drifts from f32 beyond the gates of tests/test_bf16.py')
    check(launches['rvq_encode'] > 0 and launches['lstm_recurrence'] > 0
          and launches['resblock'] == 0, f'bf16 codec launches {launches}')
    streamed = bf16_stream_check(torch, seed, models[torch.bfloat16])
    return {k: v + streamed[k] for k, v in launches.items()}


def bf16_stream_check(torch, seed, model) -> dict:
    """The bf16 model streamed through a ``StreamingServer`` (2 slots, 4 hops a
    chunk, 6 kbps), two streams of 224 hops at once, so that the batched
    steps carry both slots: each stream's codes against the offline bf16
    ``encode`` of its clip (>= 99 %) and its audio against the offline bf16
    decode (>= 20 dB SNR); K1 and K2 launched, K3 not (a bf16 block streams
    as its conv sequence). Returns the launch counts."""
    import threading

    from encodec_pytorch_tpu_torch.serve import StreamingServer
    model.set_target_bandwidth(6.)
    hop = model.encoder.hop_length
    clips = make_clip(seed + 5, batch=2, seconds=STREAM_HOPS * hop / SR)
    frames = model.encode(torch.from_numpy(clips).cuda())
    offline_codes = frames[0][0].cpu().numpy()
    offline = model.decode(frames).float().cpu().numpy()
    server = StreamingServer(model, max_streams=2, chunk_hops=CHUNK_HOPS, max_wait_ms=5.0,
                             bandwidth=6., device='cuda')
    first, chunk = FIRST_HOPS * hop, server.chunk_samples
    live = []                     # live slots of each batched step
    real_mux = server._mux

    def counted_mux(*args):
        live.append(int(args[3].sum()))
        return real_mux(*args)
    server._mux = counted_mux
    outputs, errors = [None] * len(clips), []

    def run_stream(i):
        try:
            with server.open_stream() as stream:
                pieces = [stream.process(clips[i][:, :first], timeout=120, with_codes=True)]
                for a in range(first, clips.shape[-1], chunk):
                    pieces.append(stream.process(clips[i][:, a:a + chunk], timeout=120,
                                                 with_codes=True))
            outputs[i] = tuple(np.concatenate(p, axis=-1) for p in zip(*pieces))
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append((i, repr(e)))

    reset_counts()
    threads = [threading.Thread(target=run_stream, args=(i,)) for i in range(len(clips))]
    t0 = time.perf_counter()
    with server:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        stats = server.stats()
    wall = time.perf_counter() - t0
    launches = read_counts()
    check(not errors and all(o is not None for o in outputs), f'bf16 streams failed: {errors}')
    both = sum(n == 2 for n in live)
    same = float(np.mean([np.mean(o[1] == offline_codes[i]) for i, o in enumerate(outputs)]))
    snrs = [snr_db(offline[i], o[0]) for i, o in enumerate(outputs)]
    log(f'bf16 streaming: StreamingServer over the bf16 model, 2 streams of '
        f'{clips.shape[-1] / SR:.3f} s at once in {CHUNK_HOPS}-hop chunks at 6 kbps: '
        f'{both} of {len(live)} batched steps carried both slots; codes equal to the offline '
        f'bf16 encode {same:.6f}; SNR vs the offline bf16 decode min {min(snrs):.2f} dB; tick '
        f'ms p50 {stats["tick_ms_p50"]:.3f} p99 {stats["tick_ms_p99"]:.3f}; {wall:.3f} s; '
        f'kernel launches {launches}')
    check(same >= K1_TOL_SHARE and min(snrs) >= SNR_MIN_DB,
          'the bf16 stream disagrees with the offline bf16 model')
    check(both > 0, 'no batched bf16 step carried both streams')
    check(launches['rvq_encode'] > 0 and launches['lstm_recurrence'] > 0
          and launches['resblock'] == 0, f'bf16 streaming launches {launches}')
    return launches


# deployed artifacts (deploy.py) and segment-parallel inference (parallel/segment.py)
DEPLOY_BANDWIDTH = 6.
DEPLOY_REQUESTS = 16
DEPLOY_WAV_REL = 1e-6
# segment-parallel against one process and against the sequential model, fixed
# before the first run on the card
SEG_CODES_SHARE = 0.999
SEG_WAV_REL = 1e-5
SEG_RANKS = 2
SEG_TIMEOUT = 300


def _frames_of(out, normalize: bool):
    """(codes tuple, scales tuple or None) of an encode's output."""
    return (tuple(out[0]), tuple(out[1])) if normalize else (tuple(out), None)


def _median_s(torch, fn, runs: int) -> float:
    fn()
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def deploy_phase(torch, seed, tmp: Path, ckpt: Path, model_name: str, smi: str) -> dict:
    """``deploy_cli`` on the seeded full-width ``model_name`` (10 s entries at
    6 kbps, all three kinds; folded weights where the model has weight norm),
    ``DeployedCodec.load`` on the card, its calls against ``LiveCodec``, a
    ``CodecServer`` over it, roundtrip RTF at B 1 and 16 against LiveCodec.
    Returns the K1, K2, K3 launches of the artifact's calls and its server."""
    import threading

    from encodec_pytorch_tpu_torch import deploy_cli
    from encodec_pytorch_tpu_torch.deploy import DeployedCodec
    from encodec_pytorch_tpu_torch.models.model import MODELS
    from encodec_pytorch_tpu_torch.serve import CodecServer, LiveCodec

    model = MODELS[model_name](checkpoint=ckpt, device='cuda')
    fold = model.segment is None                 # the 24 kHz model has weight norm
    weights = 'fold' if fold else 'raw'
    path = tmp / f'{model_name}.ecdz'
    t0 = time.perf_counter()
    meta = deploy_cli.main([str(path), '-m', model_name, '-c', str(ckpt), '--seconds',
                            str(SECONDS), '--bandwidths', f'{DEPLOY_BANDWIDTH:g}', '--weights',
                            weights, '--device', 'cuda', '-f'])
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    codec = DeployedCodec.load(path, device='cuda')
    load_s = time.perf_counter() - t0
    live = LiveCodec(model, default_bandwidth=DEPLOY_BANDWIDTH, weights=weights, device='cuda')
    sr, channels, normalize = model.sample_rate, model.channels, model.normalize
    log(f'{model_name} artifact on {smi}: deploy_cli --seconds {SECONDS} --bandwidths '
        f'{DEPLOY_BANDWIDTH:g} --weights {weights}, all kinds: {len(meta["entries"])} entries '
        f'{[e["name"] for e in meta["entries"]]}, n_q {meta["entries"][0]["n_q"]}, frames '
        f'{meta["entries"][0]["frame_tfs"]}; export {export_s:.2f} s (model load and '
        f'tracing on the card\'s host), {path.stat().st_size} bytes; DeployedCodec.load onto '
        f'the card {load_s:.2f} s')
    x = torch.from_numpy(make_clip(seed + 80, 1, SECONDS, sr, channels)).cuda()
    reset_counts()
    codes, scales = _frames_of(codec.encode(x), normalize)
    wav = codec.decode(codes, scales)
    rt = codec.roundtrip(x)
    torch.cuda.synchronize()
    launches = read_counts()
    log(f'{model_name} artifact: kernel launches over encode, decode and roundtrip {launches}')
    check(launches['rvq_encode'] > 0 and launches['lstm_recurrence'] > 0,
          f'the artifact did not launch K1 and K2: {launches}')
    check((launches['resblock'] > 0) == fold,
          f'K3 launched {launches["resblock"]} times (weight norm: {fold})')
    lcodes, lscales = _frames_of(live.encode(x), normalize)
    lwav = live.decode(lcodes, lscales)
    lrt = live.roundtrip(x)
    check(len(codes) == len(lcodes) == meta['entries'][0]['n_frames'],
          f'{len(codes)} frames, LiveCodec {len(lcodes)}')
    codes_equal = all(torch.equal(a, b) for a, b in zip(codes, lcodes))
    scales_equal = scales is None or all(torch.equal(a, b) for a, b in zip(scales, lscales))
    rel_dec, rel_rt = _rel_norm(wav, lwav), _rel_norm(rt, lrt)
    log(f'{model_name} artifact vs LiveCodec(weights={weights!r}) on the card, {SECONDS} s at '
        f'{DEPLOY_BANDWIDTH:g} kbps: {len(codes)} frames of code lengths '
        f'{[c.shape[-1] for c in codes]}, codes identical {codes_equal}, scales identical '
        f'{scales_equal}; decode relative error {rel_dec:.3e} (bit-equal '
        f'{torch.equal(wav, lwav)}), roundtrip {rel_rt:.3e} (bit-equal {torch.equal(rt, lrt)})')
    check(codes_equal and scales_equal and max(rel_dec, rel_rt) <= DEPLOY_WAV_REL,
          f'the {model_name} artifact disagrees with LiveCodec')

    clips = make_clip(seed + 81, DEPLOY_REQUESTS, SECONDS, sr, channels)
    ref = live.roundtrip(clips).cpu().numpy()
    reset_counts()
    server = CodecServer(codec, max_batch=DEPLOY_REQUESTS, max_wait_ms=50.0)
    futures = [server.submit('roundtrip', c) for c in clips]      # before the worker starts
    t0 = time.perf_counter()
    server.start()
    try:
        outs = [f.result(timeout=300) for f in futures]
    finally:
        server.stop()
    wall = time.perf_counter() - t0
    for k, v in read_counts().items():
        launches[k] += v
    stats = server.stats()
    rels = [_rel_norm(torch.from_numpy(o), torch.from_numpy(r)) for o, r in zip(outs, ref)]
    equal = sum(np.array_equal(o, r) for o, r in zip(outs, ref))
    log(f'{model_name} artifact: CodecServer, {DEPLOY_REQUESTS} round trips of {SECONDS} s in '
        f'{stats["batches"]} batch(es) of mean {stats["mean_batch"]:.1f}, {wall:.3f} s; against '
        f'LiveCodec on the same 16 clips at once: max relative error {max(rels):.3e}, '
        f'{equal} of {DEPLOY_REQUESTS} bit-equal')
    check(len(outs) == DEPLOY_REQUESTS and max(rels) <= DEPLOY_WAV_REL,
          'the CodecServer over the artifact disagrees with LiveCodec')

    x16 = torch.from_numpy(clips).cuda()
    rtf = {}
    for name, fn in (('artifact', codec.roundtrip), ('LiveCodec', live.roundtrip)):
        for batch, xb, runs in ((1, x, 5), (16, x16, 3)):
            t = _median_s(torch, lambda: fn(xb), runs)
            rtf[(name, batch)] = (batch * SECONDS / t, 1e3 * t)
    log(f'{model_name} roundtrip RTF on {smi} (audio seconds a second; median ms): '
        + ', '.join(f'{n} B {b}: {v[0]:.2f} ({v[1]:.1f} ms)' for (n, b), v in rtf.items()))
    return launches


def _seg_clip(seed: int):
    return make_clip(seed + 90, 1, SECONDS, SR48, 2)


def seg_rank_main(rank: int, folder: Path) -> int:
    """A rank of the segment-parallel phase: joins the gloo group at
    ``folder``, codes the clip with its share of the segments, saves the
    frames, the wav, its ms and its launches."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT))
    from encodec_pytorch_tpu_torch.models.model import encodec_model_48khz
    from encodec_pytorch_tpu_torch.ops import _build
    from encodec_pytorch_tpu_torch.parallel import DataParallel
    from encodec_pytorch_tpu_torch.parallel.segment import decode_parallel, encode_parallel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.load()
    spec = torch.load(folder / 'spec.pt', weights_only=True)
    model = encodec_model_48khz(checkpoint=spec['ckpt'], device='cuda')
    model.set_target_bandwidth(DEPLOY_BANDWIDTH)
    x = spec['x'].cuda()
    dist.init_process_group('gloo', init_method=f'file://{folder}/rendezvous', rank=rank,
                            world_size=SEG_RANKS)
    try:
        dp = DataParallel()
        decode_parallel(model, encode_parallel(model, x, dp), dp)        # warm-up
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frames = encode_parallel(model, x, dp)
        wav = decode_parallel(model, frames, dp)[:, :, :x.shape[-1]]
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        torch.save({'codes': [c.cpu() for c, _ in frames], 'scales': [s.cpu() for _, s in frames],
                    'wav': wav.cpu(), 'ms': ms, 'launches': read_counts()},
                   folder / f'rank{rank}.pt')
    finally:
        dist.destroy_process_group()
    return 0


def segment_parallel_phase(torch, seed, tmp: Path, ckpt: Path, smi: str) -> dict:
    """``roundtrip_parallel`` on the seeded 48 kHz model: one process against
    the sequential ``model(x)``, then 2 ranks on the card over gloo against
    each other (bit-equal) and against one process (``SEG_CODES_SHARE``,
    ``SEG_WAV_REL``). Returns the K1, K2, K3 launches of both runs."""
    from encodec_pytorch_tpu_torch.models.model import encodec_model_48khz
    from encodec_pytorch_tpu_torch.parallel.segment import decode_parallel, encode_parallel

    model = encodec_model_48khz(checkpoint=ckpt, device='cuda')
    model.set_target_bandwidth(DEPLOY_BANDWIDTH)
    x = torch.from_numpy(_seg_clip(seed)).cuda()
    decode_parallel(model, encode_parallel(model, x))                    # warm-up
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    frames = encode_parallel(model, x)
    par = decode_parallel(model, frames)[:, :, :x.shape[-1]]
    torch.cuda.synchronize()
    par_ms = 1e3 * (time.perf_counter() - t0)
    launches = read_counts()
    t0 = time.perf_counter()
    seq_frames = model.encode(x)
    seq = model.decode(seq_frames)[:, :, :x.shape[-1]]
    torch.cuda.synchronize()
    seq_ms = 1e3 * (time.perf_counter() - t0)
    codes = torch.cat([c for c, _ in frames], -1)
    share = float((codes == torch.cat([c for c, _ in seq_frames], -1)).float().mean())
    rel = _rel_norm(par, seq)
    log(f'segment parallel on {smi}: encodec_48khz, {SECONDS} s stereo at '
        f'{DEPLOY_BANDWIDTH:g} kbps, {len(frames)} frames ({len(frames) - 1} full segments in '
        f'one call, the tail in its own): one process {par_ms:.1f} ms, the sequential '
        f'model {seq_ms:.1f} ms; against the sequential model codes identical {share:.6f}, '
        f'wav relative error {rel:.3e} (bars {SEG_CODES_SHARE}, {SEG_WAV_REL:g}); launches '
        f'{launches}')
    check(launches['rvq_encode'] > 0 and launches['lstm_recurrence'] > 0
          and launches['resblock'] == 0, f'segment-parallel launches {launches}')
    check(share >= SEG_CODES_SHARE and rel <= SEG_WAV_REL,
          'roundtrip_parallel disagrees with the sequential model')

    folder = tmp / 'seg_ranks'
    folder.mkdir()
    torch.save({'ckpt': str(ckpt), 'x': x.cpu()}, folder / 'spec.pt')
    logs = [open(folder / f'rank{r}.log', 'w') for r in range(SEG_RANKS)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, str(ROOT / 'chip_smoke.py'), '--seg-rank', str(r),
                               '--seg-dir', str(folder)], env=dict(os.environ, OMP_NUM_THREADS='4'),
                              stdout=logs[r], stderr=subprocess.STDOUT) for r in range(SEG_RANKS)]
    try:
        exits = [p.wait(timeout=SEG_TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    wall = time.perf_counter() - t0
    for r, code in enumerate(exits):
        if code != 0:
            log(f'segment parallel: rank {r} failed ({code}); the end of its output:')
            for line in (folder / f'rank{r}.log').read_text().splitlines()[-40:]:
                log(f'  {line}')
    check(exits == [0] * SEG_RANKS, f'a segment-parallel rank failed: exit codes {exits}')
    res = [torch.load(folder / f'rank{r}.pt', weights_only=True) for r in range(SEG_RANKS)]
    a, b = res
    ranks_equal = (all(torch.equal(p, q) for p, q in zip(a['codes'] + a['scales'],
                                                          b['codes'] + b['scales']))
                   and torch.equal(a['wav'], b['wav']))
    rcodes = torch.cat(a['codes'], -1)
    share1 = float((rcodes == codes.cpu()).float().mean())
    rel1 = _rel_norm(a['wav'], par.cpu())
    log(f'segment parallel: {SEG_RANKS} ranks on the one card over gloo, each '
        f'{(len(frames) - 1) // SEG_RANKS} of the {len(frames) - 1} full segments: ms '
        f'{[round(r["ms"], 1) for r in res]} (gathers staged through the host), '
        f'{wall:.1f} s from start to exit; ranks bit-equal {ranks_equal}; against one process '
        f'codes identical {share1:.6f}, wav relative error {rel1:.3e} (bars {SEG_CODES_SHARE}, '
        f'{SEG_WAV_REL:g}), bit-equal {torch.equal(a["wav"], par.cpu())}; launches '
        f'{[r["launches"] for r in res]}')
    check(ranks_equal, 'the segment-parallel ranks disagree')
    check(share1 >= SEG_CODES_SHARE and rel1 <= SEG_WAV_REL,
          'the 2-rank segment-parallel run disagrees with one process')
    for r in res:
        for k, v in r['launches'].items():
            launches[k] += v
    return launches


def run(seed: int, before_dir=None) -> int:
    try:
        import torch
    except ImportError:
        print('chip_smoke: torch is not installed', file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; this check runs only on the GPU', file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        from encodec_pytorch_tpu_torch.ops import _build, lstm_kernel, rvq_kernel
    except ImportError as e:
        print(f'chip_smoke: run from the root of a checkout ({e})', file=sys.stderr)
        return 2

    smi = nvidia_smi_line()
    log(f'device: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    log(f'tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, '
        f'cudnn {torch.backends.cudnn.allow_tf32}; bf16 reduced-precision reduction in cuBLAS '
        f'{torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}')

    _build.load()
    log(f'build: {_build.BuildInfo.seconds:.2f} s (nvcc ran: {_build.BuildInfo.compiled}) '
        f'-> {_build.BuildInfo.path}')
    for line in _build.BuildInfo.log.splitlines():
        if 'registers' in line or 'spill' in line or 'Compiling entry' in line:
            log(f'  ptxas: {line.strip()}')

    before = None
    if before_dir is not None:
        before = load_before(before_dir)
        before._build.load()
        log(f'--before {before_dir}: built in {before._build.BuildInfo.seconds:.2f} s -> '
            f'{before._build.BuildInfo.path}')
    gen = torch.Generator(device='cuda').manual_seed(seed)
    phase('K1')
    k1 = k1_phase(torch, rvq_kernel, gen, before)
    phase('K2')
    k2 = k2_phase(torch, lstm_kernel, gen)
    with tempfile.TemporaryDirectory() as tmp:
        phase('codec CLI')
        cli_launches = main_path_phase(torch, seed, Path(tmp))
        phase('bf16 codec')
        codec16_launches = bf16_codec_phase(torch, seed, Path(tmp) / CKPT)
        for k in CODEC_KERNELS:
            cli_launches[k] += codec16_launches[k]
        phase('K3')
        k3 = k3_phase(torch, seed, Path(tmp) / CKPT, before)
        phase('serving')
        serve_launches = serving_phase(torch, seed, Path(tmp) / CKPT)
        phase('int8 serving')
        k2_i8, k3_i8, int8_launches = int8_phase(torch, seed, Path(tmp) / CKPT, gen)
        phase('LM codec')
        k6, lm_launches = lm_codec_phase(torch, seed, Path(tmp), before)
        phase('LM training')
        lm_train = lm_train_phase(torch, seed, Path(tmp))
        phase('trained LM codec')
        held = trained_lm_cli_phase(torch, seed, Path(tmp), lm_train['path'])
        phase('streaming LM coder')
        stream = lm_stream_phase(torch, seed, lm_train['path'], held['codes'], before)
        phase('kv_cache=False LM coder')
        kv_free = kv_free_phase(torch, lm_train['path'], held['codes'])
        phase('conv norms')
        norm_launches = conv_norms_phase(torch, seed)
        phase('24 kHz artifact')
        deploy24 = deploy_phase(torch, seed, Path(tmp), Path(tmp) / CKPT, 'encodec_24khz', smi)
    launches = {k: cli_launches[k] + serve_launches[k] + lm_launches[k] + int8_launches[k]
                + deploy24[k] + lm_train['launches'][k] + norm_launches[k]
                for k in CODEC_KERNELS}
    lm_launches['lm_coder'] += held['lm_coder'] + kv_free['lm_coder']
    phase('K4')
    k4_fwd, k4_dx = k4_phase(torch, seed, before=before)
    with tempfile.TemporaryDirectory() as tmp:
        phase('training')
        train_launches, train32 = training_phase(torch, seed, Path(tmp),
                                                 extra=['tpu.compute_dtype=float32'],
                                                 label='config (float32)')
    with tempfile.TemporaryDirectory() as tmp:
        phase('training bf16')
        bf16_entries = _bf16_entries()
        bf16_launches, train16 = training_phase(
            torch, seed, Path(tmp), label='config (the default, bfloat16)',
            entries={k: bf16_entries[k] for k in BF16_ENTRIES[:2]})
    log('training config, bfloat16 against float32 (one run, each a train_cli epoch of 3 steps '
        'and one profiled step): ' + ', '.join(
            f'{k} {train16[k]:.3f} vs {train32[k]:.3f}'
            for k in ('step_ms', 'busy_ms', 'idle', 'peak_gb')))
    with tempfile.TemporaryDirectory() as tmp:
        phase('trainer state')
        state_launches = trainer_state_phase(torch, seed, Path(tmp), smi)
    for k in CODEC_KERNELS:
        launches[k] += state_launches[k]
    for k in TRAIN_KERNELS:
        train_launches[k] += state_launches[k]
    with tempfile.TemporaryDirectory() as tmp:
        phase('mono nq2')
        mono = mono_nq2_phase(torch, seed, Path(tmp), smi)
    for k in CODEC_KERNELS:
        launches[k] += mono['launches'][k]
    for k in TRAIN_KERNELS:
        train_launches[k] += mono['launches'][k]
    phase('K4 at mono nq2')
    k4_fwd_m, k4_dx_m = k4_phase(torch, seed, 'config_mono_nq2', before)
    phase('K4 at 48 kHz')
    k4_fwd48, k4_dx48 = k4_phase(torch, seed, 'config_48k_stereo', before)
    for summary, at48, mono_shapes in ((k4_fwd, k4_fwd48, k4_fwd_m), (k4_dx, k4_dx48, k4_dx_m)):
        summary['shapes'] = [dict(summary, config='config'), dict(at48, config='config_48k_stereo'),
                             dict(mono_shapes, config='config_mono_nq2')]
        summary['max_abs_err'] = max(summary['max_abs_err'], at48['max_abs_err'],
                                     mono_shapes['max_abs_err'])
    phase('K5')
    k5 = k5_phase(torch, seed, before)
    with tempfile.TemporaryDirectory() as tmp:
        phase('48 kHz codec CLI')
        cli48_launches = codec48_phase(torch, seed, Path(tmp))
        phase('48 kHz CodecServer')
        serve48_launches = server48_phase(torch, seed, Path(tmp) / CKPT48)
        phase('48 kHz LM codec')
        lm48_launches, lm48_err = lm48_phase(torch, seed, Path(tmp))
        phase('48 kHz artifact')
        deploy48 = deploy_phase(torch, seed, Path(tmp), Path(tmp) / CKPT48, 'encodec_48khz',
                                smi)
        phase('segment parallel')
        seg_launches = segment_parallel_phase(torch, seed, Path(tmp), Path(tmp) / CKPT48, smi)
    k6['max_abs_err'] = max(k6['max_abs_err'], float(lm48_err))
    for k in CODEC_KERNELS:
        launches[k] += (cli48_launches[k] + serve48_launches[k] + lm48_launches[k]
                        + deploy48[k] + seg_launches[k])
    with tempfile.TemporaryDirectory() as tmp:
        phase('48 kHz training')
        train48_launches, _ = training_phase(torch, seed, Path(tmp), 'config_48k_stereo')
    phase('K4 bf16')
    k4_fwd16, k4_dx16 = k4_bf16_phase(torch, seed, before)
    phase('K5 bf16')
    k5_16 = k5_bf16_phase(torch, seed, before)
    phase('48 kHz bf16 step')
    step48_launches = step48_bf16_phase(torch, seed)
    for k in BF16_ENTRIES[:2]:
        bf16_launches[k] += step48_launches[k]
    bf16_launches[BF16_ENTRIES[2]] = step48_launches[BF16_ENTRIES[2]]
    phase('accumulation and guard')
    accum_guard_phase(torch, seed)
    with tempfile.TemporaryDirectory() as tmp:
        phase('data parallel')
        dp_launches = data_parallel_phase(torch, seed, Path(tmp), smi)
    for k in BF16_ENTRIES[:2]:
        bf16_launches[k] += dp_launches[k]
    for k in TRAIN_KERNELS:
        train_launches[k] += dp_launches[k]
    for k in CODEC_KERNELS:
        launches[k] += dp_launches[k]
    phase('done')

    k4_src = 'encodec_pytorch_tpu_torch/csrc/disc_conv.cu'
    k4_src16 = 'encodec_pytorch_tpu_torch/csrc/disc_conv_bf16.cu'
    k4_tpu = 'encodec_pytorch_tpu/ops/pallas_conv2d_v2.py:114'
    kernels = [
        dict(name='rvq_encode', route='cuda', source='encodec_pytorch_tpu_torch/csrc/rvq.cu',
             replaces='encodec_pytorch_tpu/ops/pallas_vq.py:31',
             launches=launches['rvq_encode'], **k1),
        dict(name='lstm_recurrence', route='cuda',
             source='encodec_pytorch_tpu_torch/csrc/lstm.cu',
             replaces='encodec_pytorch_tpu/ops/pallas_lstm.py:22',
             launches=launches['lstm_recurrence'], **k2),
        dict(name='resblock', route='cuda', source='encodec_pytorch_tpu_torch/csrc/resblock.cu',
             replaces='encodec_pytorch_tpu/ops/pallas_resblock.py:34',
             launches=launches['resblock'], **k3),
        dict(name='lstm_recurrence_int8', route='cuda',
             source='encodec_pytorch_tpu_torch/csrc/lstm.cu',
             replaces='encodec_pytorch_tpu/ops/pallas_lstm.py:22',
             launches=int8_launches['lstm_recurrence_int8'], **k2_i8),
        dict(name='resblock_int8', route='cuda',
             source='encodec_pytorch_tpu_torch/csrc/resblock.cu',
             replaces='encodec_pytorch_tpu/ops/pallas_resblock.py:34',
             launches=int8_launches['resblock_int8'], **k3_i8),
        dict(name='disc_conv_forward', route='cuda', source=k4_src, replaces=k4_tpu,
             launches=train_launches['disc_conv_forward']
             + train48_launches['disc_conv_forward'], **k4_fwd),
        dict(name='disc_conv_input_grad', route='cuda', source=k4_src, replaces=k4_tpu,
             launches=train_launches['disc_conv_input_grad']
             + train48_launches['disc_conv_input_grad'], **k4_dx),
        dict(name='disc_im2col_forward', route='cuda',
             source='encodec_pytorch_tpu_torch/csrc/disc_im2col.cu',
             replaces='encodec_pytorch_tpu/ops/pallas_conv2d.py:42',
             launches=train48_launches['disc_im2col_forward'], **k5),
        dict(name='lm_coder', route='cuda', source='encodec_pytorch_tpu_torch/csrc/lm_coder.cu',
             replaces='encodec_pytorch_tpu/bitstream/fused.py:191',
             launches=lm_launches['lm_coder'] + lm48_launches['lm_coder'], **k6),
        dict(name='lm_coder_stream', route='cuda',
             source='encodec_pytorch_tpu_torch/csrc/lm_coder.cu',
             replaces='encodec_pytorch_tpu/bitstream/fused.py:656',
             launches=stream['launches'], **stream['summary']),
        dict(name='disc_conv_forward_bf16', route='cuda', source=k4_src16, replaces=k4_tpu,
             launches=bf16_launches['disc_conv_forward_bf16'], **k4_fwd16),
        dict(name='disc_conv_input_grad_bf16', route='cuda', source=k4_src16, replaces=k4_tpu,
             launches=bf16_launches['disc_conv_input_grad_bf16'], **k4_dx16),
        dict(name='disc_im2col_forward_bf16', route='cuda',
             source='encodec_pytorch_tpu_torch/csrc/disc_im2col_bf16.cu',
             replaces='encodec_pytorch_tpu/ops/pallas_conv2d.py:42',
             launches=bf16_launches['disc_im2col_forward_bf16'], **k5_16),
    ]
    log(json.dumps(json_safe({'kernels': kernels}), allow_nan=False))
    log(smi)
    log(json.dumps({'ok': True, 'device': {'platform': 'gpu',
                                           'kind': torch.cuda.get_device_name(0),
                                           'count': torch.cuda.device_count()}}))
    return 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--before', type=Path, default=None,
                        help='another checkout of the port (e.g. the parent commit): the K1, '
                             'K3, K5 and K4 bf16 phases also time its kernels and compare their '
                             'outputs')
    parser.add_argument('--dp-rank', type=int, default=None, help=argparse.SUPPRESS)
    parser.add_argument('--dp-dir', type=Path, default=None, help=argparse.SUPPRESS)
    parser.add_argument('--seg-rank', type=int, default=None, help=argparse.SUPPRESS)
    parser.add_argument('--seg-dir', type=Path, default=None, help=argparse.SUPPRESS)
    args = parser.parse_args()
    try:
        if args.dp_rank is not None:        # a rank of the data-parallel phase
            return dp_rank_main(args.dp_rank, args.dp_dir)
        if args.seg_rank is not None:       # a rank of the segment-parallel phase
            return seg_rank_main(args.seg_rank, args.seg_dir)
        return run(args.seed, args.before)
    except (Exception, SystemExit) as e:   # any phase's failure fails the run
        traceback.print_exc()
        print(f'chip_smoke: FAILED: {e!r}', file=sys.stderr)
        return 1


if __name__ == '__main__':
    sys.exit(main())
