"""Smoke run of the PyTorch/CUDA port (brever_tpu_torch) on one GPU.

Drives the port's serving and training paths for full-width non-causal
Conv-TasNet (filters 512, bottleneck 128, hidden 512, skip 128, 8 layers
x 3 repeats; 4,935,217 random parameters from a numpy seed), full-width
TF-GridNet (n_fft 256, stride 128, 6 layers, LSTM hidden 128, 4 heads,
qk 512, emb 32, ks = hs = 4; 3,735,344 random parameters from a seed),
full-width SGMSE+ (``sgmsep``, the NCSN++ U-Net: 128 base channels, mults
1, 1, 2, 2, 2, 2, 2, two blocks a level, attention at 16 frequencies and
the bottleneck; 65,590,694 random parameters from a seed), full-width
DCCRN (STFT 512/128, channels 16-32-64-128-128-128, kernel (5, 2), stride
(2, 1), two complex LSTM layers of 128, batch norm; 3,671,053 random
parameters from a seed), MANNER (its only width: hidden 60, depth 4,
69 BatchNorms; 21,253,921 random parameters from a seed), and IDMSE
(``idmse``, the ADM U-Net: 64 base channels, mults 1, 2, 3, 4, one block
a level; 16,613,378 random parameters from a seed) and ``idmselarge``
(SGMSE+'s U-Net geometry with ADM blocks; 70,995,586) on the card, and the
elementwise-rate probe (K10) in float32 and bfloat16, FFNN (64 mel
bands, 5 stacks, hidden 1024-1024; 1,509,440 random parameters from a
seed) with the validation-metric twins on the card, the host metric twins,
MetricGAN+ and MetricGAN-OKD (two BLSTMs of 200 units and a spectrally
normalised CNN discriminator; 1,914,524 and 2,172,329 random parameters
from a seed) and ``test_model``; and the default Conv-TasNet under bf16 amp, its TCN
blocks on K1's and K2's bf16 route, and the default TF-GridNet and DCCRN
under bf16 amp, their LSTMs on the bf16 route of K3/K4 and K5/K6.
Every family is served through ``EnhanceService(model_dir)`` and trained
through ``train.main([...])`` on a model directory written here, the entry
points of ``python -m brever_tpu_torch.serve`` and ``.train``. The phases
each print one line, with the seconds since the start:

0. the card (nvidia-smi name and power limit), versions, optional deps;
1. build the CUDA kernels from brever_tpu_torch/csrc with nvcc;
2. the TCN block forward kernel (K1) against its plain PyTorch version;
3. the full model's enhance on the card against the plain path on a
   CPU copy;
4. the HTTP service (/health, three /enhance requests) on the card;
5. timings: per-block forward kernel vs plain version, full enhance;
6. the TCN block backward kernel (K2) against its plain version, and
   twice on the same inputs (bitwise equal); its recomputed z1 bitwise the
   forward's (PReLU of it is K1's h1); its launches' device times at d = 1
   and d = 128 from a trace;
7. full-model gradients on the card against the plain CPU path;
8. training through train.main on a WAV dataset written here: the loss
   falls, last.ckpt resumes, the checkpoint serves;
9. timings: per-block backward kernel vs plain version, the full train
   step with kernel and with plain blocks, peak memory (beside PR 9's
   step);
10. the LSTM kernels (K3 forward, K4 backward) against their plain
    versions at TF-GridNet's intra and inter shapes and ragged ones (H = 32
    and 256 at R off the tile), the backward in float64, and twice on the
    same inputs (bitwise equal);
11. TF-GridNet's enhance on the card against the plain path in float64;
12. TF-GridNet's full-model gradients (multiresyu) against the plain
    path in float64, beside the plain float32 path's;
13. TF-GridNet trained through train.main on a WAV dataset written here:
    the loss falls, last.ckpt resumes bitwise, the checkpoint serves;
14. the HTTP service over that model directory's checkpoint;
15. timings: K3 and K4 per BLSTM vs plain and cuDNN's LSTM, K4's five
    launches (gates GEMM, reverse scan, dx GEMM, weight GEMM, sums) from a
    trace and its plan (blocks, shared memory, chunks), enhance and the
    train step with kernel and with plain LSTMs, peak memory;
16. the GroupNorm kernels (K7 forward, one launch; K8 backward, two)
    against their plain versions at the U-Net's shapes and ragged ones (odd
    N, C = 384, B = 1, G = C, unaligned), on every route of their cluster
    plan, SiLU, none and ReLU; the backward in float64; both twice bitwise;
17. SGMSE+'s denoiser (2 x 4 s) and ``enhance`` (1 x 2 s, 32 U-Net
    evaluations, one generator seed) against the plain path in float64,
    beside the plain float32 path's; K7 launches per evaluation;
18. SGMSE+'s full-model gradients (2 x 2 s, t and noise fixed) against the
    plain path in float64, beside the plain float32 path's;
19. SGMSE+ trained through train.main on a WAV dataset written here: the
    fixed-generator validation loss falls, last.ckpt (with ``aux``, the
    Fourier frequencies, and the generator's state) resumes bitwise;
20. the HTTP service over that model directory's checkpoint;
21. timings: K7 and K8 at the largest shape (and there with clusters of
    at most 8 blocks) and summed over one U-Net evaluation at 4 x 4 s (the
    card's time, calls queued behind a sleep kernel; as issued; the host's
    time a call; each shape's route and cluster), beside their plain
    versions and ``F.group_norm`` + ``F.silu``; the denoiser at 4 x 4 s,
    ``enhance`` of 1 x 2 s, the train step at 4 x 4 s (kernel and plain
    GroupNorms) and at 8 x 4 s, peak memory;
22. the gates-in LSTM scan kernels (K5 forward, K6 backward) against
    their plain versions at DCCRN's two complex-LSTM shapes at 16 x 4 s
    and at B = 1, TF-GridNet's short-request intra shape, H 32..256 at
    T = 1 and unaligned inputs; the forward also against float64, the
    backward in float64; both twice bitwise;
23. DCCRN's enhance from ``EnhanceService(model_dir)`` (running statistics
    moved by train-mode passes) against the plain path in float64 and the
    plain CPU service; K5 launches per evaluation;
24. DCCRN's gradients (2 x 2 s, train mode) and its running-statistics
    update against the plain path in float64, beside the plain float32
    path's;
25. DCCRN trained through train.main on a WAV dataset written here: the
    snr loss falls, last.ckpt (with ``aux['batch_stats']``) resumes
    bitwise, the checkpoint serves;
26. the HTTP service over that model directory's checkpoint;
27. timings at 16 x 4 s: K5 and K6 per complex-LSTM layer vs their plain
    versions (the cluster's blocks, us a step and shared memory a block),
    the projection + K5 route vs K3 (projection
    inside) and K6 vs K4 at the same shape, cuDNN's LSTM over both weight
    sets and over one, enhance and the train step with kernel and with
    plain LSTMs, peak memory.
28. the flash-BN kernels (K7-BN forward, K8-BN backward) against their
    plain versions at MANNER's shape classes at 16 x 4 s (C = 60 at full
    length, 120, 1920, and C = 1 over the attention chunks), none, ReLU
    and SiLU; the backward in float64, twice bitwise;
29. MANNER from ``EnhanceService(model_dir)`` (running statistics moved by
    train-mode passes): enhance against the plain path in float64, HTTP
    requests of 0.05 and 4 s, no K7-BN launch in eval mode;
30. MANNER's gradients (2 x 2 s, train mode) and running statistics
    against the plain-BatchNorm path in float64; 69 K7-BN and 69 K8-BN
    launches;
31. MANNER trained through train.main on a WAV dataset written here: the
    loss falls, the one-cycle learning rate follows optax's schedule,
    last.ckpt (running statistics, Adam and the schedule's count) resumes
    bitwise, the checkpoint serves;
32. timings at 16 x 4 s: K7-BN and K8-BN at the largest shape and summed
    over a step's 69 BatchNorms, beside their plain versions and
    ``F.batch_norm`` + the activation; enhance; the train step with kernel
    and with plain BatchNorms, peak memory;
33. the fused STFT (K9) against its plain version and ``torch.stft`` over
    16 x 4 s on both routes, the shared-memory FFT at 256/128, 512/128 and
    4096/1024 and the dense product at 400/100, timed; one DCCRN enhance
    with ``STFT(backend='pallas')`` (the FFT route) against the cuFFT
    route;
34. the LSTM kernels on shapes they refused before: H = 200 at TF-GridNet's
    intra shape (padded to 224) through autograd, an (E, H) past the shared
    memory routed to the projection and K5, K5/K6 at H = 640, 1024, 2048
    and 8192 (8-, 4- and 1-row tiles) against the plain path in float64 and
    twice bitwise, a row count past the int range in row chunks, and H =
    8224, past K5/K6, raising before any launch;
35. the elementwise-rate probe (K10) through ``bench_alu_dtype.bench``:
    the built library's SASS (FFMA in float32, HFMA2.BF16 and no
    conversion in bfloat16), both dtypes on the benchmark's input and a
    wider one against the plain chain, and at other k and passes on inputs
    whose chains have not converged, within ``fma_chain_limit`` at every
    element; times against the bound (a time under it fails), the bf16:f32
    ratio;
36. K5/K6 at H = 384 and 512 (16-row tiles) against their plain versions,
    the backward in float64, twice bitwise; a 128-row BLSTM at H = 384
    routed to the projection + K5; times at H = 512;
37. IDMSE from ``EnhanceService(model_dir)``: the denoiser (2 x 4 s) and
    ``enhance`` (1 x 2 s, one generator seed) against the plain path in
    float64, K7 launches per evaluation, HTTP requests of 0.05 and 2 s;
38. IDMSE's gradients (2 x 2 s) against the plain path in float64, beside
    the plain float32 path's;
39. IDMSE trained through train.main on a WAV dataset written here: the
    fixed-generator validation loss falls, last.ckpt (``aux`` and the
    generator's state) resumes bitwise, the checkpoint serves;
40. IDMSE timings: the denoiser and the train step at 4 x 4 s with kernel
    and with plain GroupNorms, ``enhance`` of 1 x 2 s, and the external-
    affine GroupNorms of an evaluation on their plain route;
41. IDMSE-large: the denoiser (2 x 4 s) against the plain path in float64,
    ``enhance`` of 1 x 2 s against the plain float32 path, one timed train
    step at 4 x 4 s with its peak memory;
42. a Conv-TasNet with 5-tap depthwise convs serves and trains on plain
    blocks (no K1 or K2 launch) against the CPU path;
43. FFNN (1,509,440 parameters; no kernel of its own: the STFT, the mel
    filterbank, the features and the MLP are cuFFT and cuBLAS) from
    ``EnhanceService(model_dir)`` with flax weights and ``stats``: enhance
    of (4, 2, 64000), ``transform``'s features and labels, the eval-mode
    loss and its gradients against the same model in float64 on the CPU;
    no kernel wrapper launches;
44. FFNN's ``pre_train`` on the card against float64 on the CPU; train.main
    from the untouched ``config/models/ffnn.yaml`` (only ``--device``,
    ``--epochs`` and ``--val_period`` given): the loss falls, ``estoi``,
    ``pesq`` and ``snr`` are scored by the device twins, last.ckpt (with
    ``aux['stats']``) resumes bitwise and serves;
45. the HTTP service over that model directory's checkpoint;
46. the validation-metric twins (STOI, ESTOI, PESQ wb and nb, SNR) on a
    batch of 16 x 4 s at ragged lengths on the card against the same twins
    in float64 on the card, the identity PESQ, each one's ms a batch;
47. timings: FFNN's f32 train step at 8 x 4 s (its config's 32 s of audio a
    batch) with its peak memory, ``enhance`` of 1 x 4 s and 16 x 4 s;
48. the host metric twins (float64 STOI, ESTOI, PESQ wb and nb with its
    realignment) on phase 46's batch: ms a batch serially and through the
    spawn pool, the pool's size and start-up, and the device twins on the
    card within their bounds of them;
49. MetricGAN+ and MetricGAN-OKD from ``EnhanceService(model_dir)`` (flax
    params and ``batch_stats``): enhance of (4, 2, 64000) against the same
    model in float64 on the CPU, two K5 launches a call, HTTP requests of
    0.05 and 4 s;
50. one GAN update at 4 x 4 s with given scores and augmented signal on
    the card against float64 on the CPU (losses, the clipped gradients,
    BatchNorm statistics, every ``u``/``sigma``; K5/K6 launches; the
    update lowers the discriminator's loss on its batch), and a step with
    ``device_metric_scoring`` that never calls the host scorer;
51. MetricGAN+ trained through train.main from its untouched default
    config (host PESQ targets: one call an item in the loader, two batched
    calls a step): finite losses, their course printed, validation by the
    device twins, last.ckpt (both optimizers, ``aux['batch_stats']``) resumes
    bitwise and serves; one epoch of MetricGAN-OKD's default config;
52. ``test_model`` over phase 51's directory and phase 8's Conv-TasNet
    (K1 launches): input-side scores equal to the host twins run directly,
    output-side ones against the float64 CPU model's, ``--device_metrics``,
    ``scores.hdf5`` where h5py imports;
53. timings: MetricGAN+'s step at 8 x 4 s (its config's 32 s a batch) in
    its three parts with the card's idle share and peak memory, enhance of
    1 x 4 s and 16 x 4 s, test_model's audio seconds a second;
54. the TCN block's bf16 route (K1-bf16, K2-bf16) at B=16 T=3999 C/H/Cs
    128/512/128, every dilation 1..128 and the last block, against its
    bf16 plain twin on the card (SNR >= 40 dB) and float64 (no farther than
    the twin), twice bitwise, K2's z1 bitwise K1's; times against the twin
    and each launch's device time;
55. the default Conv-TasNet (4,935,217 parameters) trained through
    train.main from the untouched ``config/models/convtasnet.yaml``
    (``use_amp: true``) on FLAC tars written with the port's encoder: the
    loss falls, K1-bf16 and K2-bf16 launch and no bf16 tensor reaches a
    plain twin on the card, last.ckpt resumes bitwise;
56. a K1-bf16 call and a K2-bf16 call traced in a fresh interpreter (run
    during phase 55): each launches only its own kernels;
57. the amp train step at 16 x 4 s against the float32 step in turns, with
    the bf16 kernels' device time a step and the card's idle share;
58. the LSTM kernels' bf16 route (K3-bf16, K4-bf16 at TF-GridNet's intra
    and inter BLSTMs and H = 32, 256; K5-bf16, K6-bf16 at DCCRN's two
    layers, 8 rows and H = 224) against the bf16 twin on the card (SNR >= 35
    dB for h, c and every gradient over the full scan) and float64 (no
    farther than the twin), twice bitwise, K4-bf16's recomputed gates
    bitwise K3-bf16's; times against the twin and cuDNN's LSTM in bf16;
59. a call of each of K3-bf16, K4-bf16, K5-bf16 and K6-bf16 traced in a
    fresh interpreter (run during phases 58-61): each launches only its own
    kernels;
60. the default TF-GridNet (3,735,344 parameters) trained through
    train.main from the untouched ``config/models/tfgridnet.yaml``
    (``use_amp: true``) on FLAC tars: K3-bf16 and K4-bf16 launch, no bf16
    tensor reaches an LSTM twin on the card, last.ckpt resumes bitwise;
61. the same for the default DCCRN (3,671,053) from ``dccrn.yaml``: K5-bf16
    and K6-bf16, its running statistics float32;
62. TF-GridNet's and DCCRN's amp train steps at 16 x 4 s against their
    float32 steps in turns, with peak memory, the LSTM kernels' device time
    a step and the card's idle share;
63. K7-, K8-, K7-BN- and K8-BN-bf16 against their bf16 twins and float64
    at every GroupNorm class of an ``sgmsep`` and an ``idmse`` evaluation
    at 4 x 4 s, ragged and unaligned shapes, and every BatchNorm class of a
    MANNER step at 16 x 4 s (every route of the bf16 plans), reruns
    bitwise; their times at the largest shapes against the float32 route,
    the twin and the library in bf16, K8-BN-bf16 on both routes; the
    launches of a call from a fresh-interpreter trace (their own kernels
    at ``__nv_bfloat16``, no cuDNN);
64. the default ``sgmsep`` (65,590,694 parameters) under bf16 amp: one
    step's loss and gradients against float64, the same amp step through
    the norms' bf16 twins and the float32 plain path; ``train.main`` from
    the untouched ``sgmsep.yaml`` on FLAC tars (K7-bf16 and K8-bf16
    launch, no bf16 tensor reaches a norm twin on the card, last.ckpt
    resumes bitwise); one amp enhance;
65. the same for ``idmse`` (16,613,378) from ``idmse.yaml``, and one amp
    step each of ``idmselarge`` and ``sgmsepmheun``;
66. the same for MANNER (21,253,921) from ``manner.yaml``: K7-BN-bf16 and
    K8-BN-bf16, its running statistics float32;
67. the amp train steps of ``sgmsep`` and ``idmse`` at 4 x 4 s and MANNER
    at 16 x 4 s against their float32 steps in turns, with peak memory, the
    bf16 norm kernels' device time a step and the card's idle share (a
    trace in a fresh interpreter).

Float32 through phase 53, with TF32 off for cuDNN and cuBLAS so that the
comparisons hold the kernels to float32; phases 54-67, which run after
phase 9, take the bf16 route. Any failure raises (non-zero
exit). The line before the last is a JSON record of each kernel: its
launches on the main paths, error, time, plain time, the bound (the
least time of its bytes at 3.35 TB/s or its flops at the f32 rate of 67
TFLOP/s, K10's bfloat16 at the probe's 133.8 TFLOP/s, the bf16 routes'
(K1-K6) at the bf16 tensor-core rate of 989 TFLOP/s and 2 bytes an
element, whichever is
larger, from this run's shapes) and the time of one PyTorch call of the same
function where there is one. The last line is ``{"ok": true, "device":
{...}}``.

    python3 chip_smoke.py
"""

import contextlib
import copy
import http.client
import io
import json
import math
import os
import platform
import shutil
import subprocess
import sys
import tarfile
import tempfile
import threading
import time

import numpy as np
import torch

#: kernel vs plain version on the card: both float32, but the kernel
#: sums the GEMMs in another order and merges the gLN moments of ~2M
#: elements a row per tile, so agreement is to rounding, not bitwise
KERNEL_ATOL, KERNEL_RTOL = 1e-4, 1e-3
#: full model on the card vs the plain path on the CPU, and every
#: gradient of the backward kernel vs its plain version (float64, phase 6):
#: 60 dB is far below float32 noise (~140 dB) and far above anything
#: audible or any learning signal, so it separates "same function, other
#: summation order" from a wrong kernel; max abs err within 1e-3 of the
#: largest reference value keeps a few large errors from hiding in a good
#: SNR. Phase 7 states its own bounds, with their reasons.
MIN_SNR_DB, MAX_REL_ERR = 60.0, 1e-3
#: the tensors of a block's VJP, in the order tcn_block_bwd returns them
GRAD_NAMES = ('dx', 'w_in', 'b_in', 'a1', 'g1', 'be1', 'w_dw', 'b_dw', 'a2',
              'g2', 'be2', 'w_res', 'b_res', 'w_skip', 'b_skip')

#: TF-GridNet's full-model gradient bounds against float64 (phase 12),
#: whole gradient and worst tensor, in dB: 60 dB whole as for the served
#: output; 50 dB per tensor, 25 dB under the 75 dB the plain float32 path
#: reaches at its worst tensor (a PReLU slope of the attention norms: a
#: cancelling sum) on 2 x 2 s (its figures are printed beside). A short
#: training run's loss must end at most at this fraction of its first
#: epoch's (phase 13)
GRID_WHOLE_DB, GRID_TENSOR_DB, GRID_LOSS_RATIO = 60.0, 50.0, 0.95

DEFAULT = dict(filters=512, filter_length=32, bottleneck=128, hidden=512,
               skip=128, layers=8, repeats=3)
N_PARAMS = 4_935_217
FS = 16000
#: the default model configs that the model directories written here use
CONFIG_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          'config', 'models')
#: the card's published rates (H100 SXM, NVIDIA's data sheet): device
#: memory bytes/s and float32 flops/s outside the tensor cores, which the
#: kernels use (K10's bound, bfloat16 included, is the probe's own:
#: ``bench_alu_dtype.bound``)
HBM_BYTES_PER_S, F32_FLOPS = 3.35e12, 67e12


#: the run's start on the host clock, for each phase's elapsed time
START = time.perf_counter()


def phase(n, text):
    print(f'phase {n} [{time.perf_counter() - START:.0f} s]: {text}',
          flush=True)


def random_flax_params(rng, filters, filter_length, bottleneck, hidden,
                       skip, layers, repeats):
    """A Conv-TasNet parameter tree in the JAX package's flax layout."""
    def weight(*shape, fan_in):
        return (rng.randn(*shape) / np.sqrt(fan_in)).astype(np.float32)

    def small(*shape, center=0.0):
        return (center + 0.05 * rng.randn(*shape)).astype(np.float32)

    def dense(lead, n_in, n_out):
        return {'kernel': weight(*lead, n_in, n_out, fan_in=n_in),
                'bias': small(*lead, n_out)}

    def norm(lead, n):
        return {'scale': small(*lead, n, center=1.0), 'bias': small(*lead, n)}

    def block(lead, res):
        out = {
            'conv_in': dense(lead, bottleneck, hidden),
            'prelu_1': {'alpha': small(*lead, 1, center=0.25)},
            'GlobalLayerNorm_0': norm(lead, hidden),
            'depthwise': {'kernel': weight(*lead, 3, 1, hidden, fan_in=3),
                          'bias': small(*lead, hidden)},
            'prelu_2': {'alpha': small(*lead, 1, center=0.25)},
            'GlobalLayerNorm_1': norm(lead, hidden),
            'skip': dense(lead, hidden, skip),
        }
        if res:
            out['res'] = dense(lead, hidden, bottleneck)
        return out

    tcn = {
        'GlobalLayerNorm_0': norm((), filters),
        'bottleneck': dense((), filters, bottleneck),
        'sweeps': {f'block_{i}': block((repeats - 1,), True)
                   for i in range(layers)},
        'prelu_out': {'alpha': small(1, center=0.25)},
        'mask': dense((), skip, filters),
    }
    for i in range(layers):
        tcn[f'block_last_{i}'] = block((), i < layers - 1)
    return {
        'encoder': {'kernel': weight(filter_length, 1, filters,
                                     fan_in=filter_length)},
        'decoder': {'kernel': weight(filter_length, filters, 1,
                                     fan_in=filters)},
        'tcn': tcn,
    }


def block_inputs(rng, batch, t_total, c=128, h=512, cs=128, device='cuda'):
    """Random block input and parameters, the 2-D weights in the torch
    Linear layout (out, in) that the model passes."""
    def arr(*s, scale=0.1):
        return (rng.randn(*s) * scale).astype(np.float32)

    def mat(n, k):
        return torch.from_numpy(arr(n, k, scale=1 / np.sqrt(k))).to(device)

    def vec(*s, scale=0.1, center=0.0):
        return torch.from_numpy(center + arr(*s, scale=scale)).to(device)

    x = torch.from_numpy(arr(batch, t_total, c, scale=1.0)).to(device)
    params = (mat(h, c), vec(h), vec(1, center=0.25), vec(h, center=1.0),
              vec(h), vec(3, h, scale=0.5), vec(h), vec(1, center=0.25),
              vec(h, center=1.0), vec(h), mat(c, h), vec(c), mat(cs, h),
              vec(cs))
    return x, params


def snr_db(ref, out):
    ref = np.asarray(ref, np.float64)
    err = ref - np.asarray(out, np.float64)
    return 10 * np.log10(np.sum(ref ** 2) / max(np.sum(err ** 2), 1e-300))


def check_output(name, ref, out):
    """Finite, same shape, SNR and max-error bounds against the plain
    CPU result; returns (snr_db, max_abs_err)."""
    out = np.asarray(out)
    if out.shape != ref.shape or not np.isfinite(out).all():
        raise AssertionError(f'{name}: shape {out.shape} vs {ref.shape}, '
                             f'finite {np.isfinite(out).all()}')
    snr = snr_db(ref, out)
    err = float(np.max(np.abs(out - ref)))
    bound = MAX_REL_ERR * float(np.max(np.abs(ref)))
    if snr < MIN_SNR_DB or err > bound:
        raise AssertionError(f'{name}: SNR {snr:.2f} dB (>= {MIN_SNR_DB}), '
                             f'max err {err:.3e} (<= {bound:.3e})')
    return snr, err


def cuda_ms(fn, iters, warmup=3):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def post_wav(port, audio):
    from brever_tpu_torch.audio import read_wav, write_wav
    buf = io.BytesIO()
    write_wav(buf, audio[:, None], FS)
    conn = http.client.HTTPConnection('127.0.0.1', port, timeout=300)
    try:
        conn.request('POST', '/enhance', body=buf.getvalue(),
                     headers={'Content-Type': 'audio/wav'})
        resp = conn.getresponse()
        body = resp.read()
    finally:
        conn.close()
    if resp.status != 200:
        raise AssertionError(f'/enhance answered {resp.status}: {body!r}')
    out, fs = read_wav(io.BytesIO(body), always_2d=True)
    if fs != FS:
        raise AssertionError(f'/enhance answered {fs} Hz')
    return out[:, 0]


def write_tone_dataset(path, n_items, seconds, seed, ext='.wav'):
    """A WAV (or, with ``ext='.flac'``, FLAC: the port's encoder, 16-bit)
    dataset in the layout BreverDataset reads (``audio.tar`` with
    ``audio/{i:05d}_{mixture,foreground}.wav``, two channels): a
    low-frequency tone in white noise at about 0 dB."""
    from brever_tpu_torch.audio import write_audio
    rng = np.random.RandomState(seed)
    n = int(seconds * FS)
    t = np.arange(n) / FS
    os.makedirs(path)
    with tarfile.open(os.path.join(path, 'audio.tar'), 'w') as tar:
        for i in range(n_items):
            clean = 0.5 * np.sin(2 * np.pi * rng.uniform(100, 400) * t
                                 + rng.uniform(0, 2 * np.pi))
            mix = clean + 0.35 * rng.randn(n)
            for name, x in (('mixture', mix), ('foreground', clean)):
                buf = io.BytesIO()
                item = f'audio/{i:05d}_{name}{ext}'
                write_audio(buf, np.stack([x, x], axis=1).astype(np.float32),
                            FS, item)
                info = tarfile.TarInfo(item)
                info.size = buf.tell()
                buf.seek(0)
                tar.addfile(info, buf)


def bound(flops, nbytes, flops_per_s=F32_FLOPS):
    """(ms, 'bytes' or 'operations'): the least time the card could take
    for ``flops`` operations (float32 unless ``flops_per_s`` says another
    rate) that must move ``nbytes`` bytes."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / flops_per_s * 1e3
    return (by_bytes, 'bytes') if by_bytes >= by_ops else (by_ops,
                                                            'operations')


def write_model_dir(path, arch, train_path='none', val_path='none',
                    params=None, aux=None, model=None):
    """A model directory as the JAX package's initializer writes one: the
    default ``config.yaml`` of ``arch`` with the dataset paths (and the
    ``model`` settings updated from ``model``) and, with ``params``,
    ``checkpoints/last.ckpt`` holding them (and ``aux``)."""
    import yaml
    from brever_tpu_torch.checkpoint import save_checkpoint
    with open(os.path.join(CONFIG_DIR, f'{arch}.yaml')) as f:
        config = yaml.load(f, Loader=yaml.Loader)
    config['train_path'], config['val_path'] = train_path, val_path
    config['model'].update(model or {})
    os.makedirs(path)
    with open(os.path.join(path, 'config.yaml'), 'w') as f:
        yaml.dump(config, f)
    if params is not None:
        os.makedirs(os.path.join(path, 'checkpoints'))
        save_checkpoint(os.path.join(path, 'checkpoints', 'last.ckpt'),
                        {'params': params, 'aux': aux or {}})
    return path


def tone_model_dir(tmp, arch, seed, model=None):
    """Writes train (24 items) and val (4) tone datasets of 1 s under
    ``tmp`` and a model directory of the default ``arch`` (its model
    settings updated from ``model``) over them; returns its path."""
    paths = []
    for split, n_items, data_seed in (('train', 24, seed),
                                      ('val', 4, seed + 1)):
        paths.append(os.path.join(tmp, split))
        write_tone_dataset(paths[-1], n_items, 1.0, data_seed)
    return write_model_dir(os.path.join(tmp, 'model'), arch, *paths,
                           model=model)


def train_args(model_dir, epochs, val_period, metrics='snr,sisnr'):
    """The command line of ``python -m brever_tpu_torch.train``: batch 8
    of the 1 s items, float32."""
    return [model_dir, '--device', 'cuda', '--epochs', str(epochs),
            '--batch_sampler', 'random', '--batch_size', '8',
            '--dynamic_batch_size', 'false', '--val_metrics', metrics,
            '--val_period', str(val_period), '--use_amp', 'false']


def train_and_resume(args, epochs, counters, after_first=None, more=2):
    """``train.main(args(epochs))`` with every launch counter of
    ``counters`` set to 0 just before and read just after; then a trainer
    built from the same command line restores last.ckpt and is held
    bitwise against the first run's state (parameters, Adam's moments,
    learning rate or a schedule's count, the loss's generator, the
    buffers), and
    ``train.main`` resumes to ``epochs + more``. Returns the first and the
    resumed trainer, the first run's seconds and launch counts;
    ``after_first`` (optional) runs right after the first run."""
    from brever_tpu_torch import train
    for fn, attr in counters:
        setattr(fn, attr, 0)
    t0 = time.perf_counter()
    first = train.main(args(epochs))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = [getattr(fn, attr) for fn, attr in counters]
    if after_first is not None:
        after_first()
    probe = train.build_trainer(args(epochs + more) + ['--force'])
    probe.init_state()
    probe.load_checkpoint()
    buffers = [(a, b) for a, b in zip(probe.model.buffers(),
                                      first.model.buffers())]

    def rate(opt):   # a schedule's own count, or the constant rate
        return opt.schedule_count if opt.scheduled else opt.learning_rate

    # every optimizer: the family's one, or MetricGAN's dict of them
    optimizers = [(a, b) for (_, a, _), (_, b, _) in zip(
        probe._optimizers(), first._optimizers())]
    if not torch.equal(probe.flat, first.flat) \
            or not all(torch.equal(a.mu, b.mu) and torch.equal(a.nu, b.nu)
                       and torch.equal(a.count, b.count)
                       and rate(a) == rate(b) for a, b in optimizers) \
            or not torch.equal(probe.generator.get_state(),
                               first.generator.get_state()) \
            or not all(torch.equal(a, b) for a, b in buffers) \
            or probe.epochs_ran != epochs:
        raise AssertionError('resume did not restore the state')
    del probe
    second = train.main(args(epochs + more) + ['--force'])
    if second.epochs_ran != epochs + more \
            or len(second.loss_logger.train_loss) != epochs + more:
        raise AssertionError(f'resumed run ended at epoch '
                             f'{second.epochs_ran}')
    return first, second, seconds, launches


def check_close(name, labels, refs, gots, min_db=MIN_SNR_DB,
                max_rel=MAX_REL_ERR):
    """SNR >= ``min_db`` and max abs error <= ``max_rel`` max|ref| (None:
    no such bound) of each tensor against its reference, on its device (an
    all-zero reference wants an all-zero result); returns (worst SNR, max
    abs err)."""
    worst, max_err = float('inf'), 0.0
    for label, want, have in zip(labels, refs, gots):
        want = want.detach().double()
        have = have.detach().double().reshape(want.shape)
        if not torch.isfinite(have).all():
            raise AssertionError(f'{name} {label}: not finite')
        diff = have - want
        if not want.any():
            if diff.any():
                raise AssertionError(f'{name} {label}: '
                                     f'{diff.abs().max().item():.3e} off 0')
            continue
        snr = 10 * np.log10(want.square().sum().item()
                            / max(diff.square().sum().item(), 1e-300))
        err = diff.abs().max().item()
        bound_err = float('inf') if max_rel is None \
            else max_rel * want.abs().max().item()
        if snr < min_db or err > bound_err:
            raise AssertionError(f'{name} {label}: SNR {snr:.2f} dB (>= '
                                 f'{min_db}), max err {err:.3e} (<= '
                                 f'{bound_err:.3e})')
        worst, max_err = min(worst, snr), max(max_err, err)
    return worst, max_err


@contextlib.contextmanager
def http_service(service):
    """The service's HTTP server on a free local port in a thread; yields
    the port and ``GET /health``'s answer, and stops the server."""
    from brever_tpu_torch.serve import make_http_server
    server = make_http_server(service, '127.0.0.1', 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        port = server.server_address[1]
        conn = http.client.HTTPConnection('127.0.0.1', port, timeout=60)
        conn.request('GET', '/health')
        health = json.loads(conn.getresponse().read())
        conn.close()
        yield port, health
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    if thread.is_alive():
        raise AssertionError('server thread did not stop')


def block_f64(x, params, dilation, last, act=None, record=None):
    """The plain TCN block in float64 (x and params already float64),
    the oracle of phases 6 and 7. With ``act = (h1, h2)``, PReLU's branch
    at each element is the one the forward kernel took: at a
    pre-activation within rounding of 0 the gradient is not defined, and
    two float32 computations may take either side. With ``record``, it
    appends each PReLU's ``(input, output)`` (the output keeping its
    gradient) for the condition scales of the slopes' gradients."""
    from torch.nn.functional import linear
    from brever_tpu_torch.ops.functional import depthwise_conv1d, gln_stats
    (w_in, b_in, a1, g1, be1, w_dw, b_dw, a2, g2, be2,
     w_res, b_res, w_skip, b_skip) = params

    def prelu(z, alpha, h_kernel):
        h = torch.where(z >= 0 if h_kernel is None else h_kernel >= 0, z,
                        alpha * z)
        if record is not None:
            h.retain_grad()
            record.append((z, h))
        return h

    act = act or (None, None)
    h1 = prelu(linear(x, w_in, b_in), a1, act[0])
    mean, rstd = gln_stats(h1)
    z2 = depthwise_conv1d((h1 - mean) * rstd * g1 + be1, w_dw, b_dw,
                          dilation, (dilation, dilation))
    h2 = prelu(z2, a2, act[1])
    mean, rstd = gln_stats(h2)
    y2 = (h2 - mean) * rstd * g2 + be2
    skip = linear(y2, w_skip, b_skip)
    return (None, skip) if last else (x + linear(y2, w_res, b_res), skip)


def block_vjp_f64(x, params, g_res, g_skip, dilation, last, act):
    """Reference gradients of one block for phase 6: :func:`block_f64` on
    the kernel's PReLU branches. (The plain float32 backward itself fails
    phase 6's bound against float64 in 8 of the 16 T=3999 cases, from such
    branch flips and from the cancelling sums of the slopes' gradients.)"""
    used = [p is not None and not (last and i in (10, 11))
            for i, p in enumerate(params)]
    x = x.double().requires_grad_()
    p = [t.double().requires_grad_() if u else None
         for t, u in zip(params, used)]
    res, skip = block_f64(x, p, dilation, last, act=act)
    outs, grads = [skip], [g_skip.double()]
    if not last:
        outs.append(res)
        grads.append(g_res.double())
    got = torch.autograd.grad(outs, [x] + [t for t in p if t is not None],
                              grads)
    rest = iter(got[1:])
    return (got[0],) + tuple(next(rest) if u else None for u in used)


def check_grads(name, ref, got):
    """Per-tensor bounds of a gradient against its reference; returns
    (worst SNR, max abs err)."""
    worst, max_err = float('inf'), 0.0
    for label, want, have in zip(GRAD_NAMES, ref, got):
        if want is None:
            if have is not None:
                raise AssertionError(f'{name} {label}: unexpected gradient')
            continue
        want = want.detach().double().cpu()
        have = have.detach().double().cpu().reshape(want.shape)
        if not torch.isfinite(have).all():
            raise AssertionError(f'{name} {label}: not finite')
        snr = snr_db(want.numpy(), have.numpy())
        err = (have - want).abs().max().item()
        bound = MAX_REL_ERR * want.abs().max().item()
        if snr < MIN_SNR_DB or err > bound:
            raise AssertionError(f'{name} {label}: SNR {snr:.2f} dB (>= '
                                 f'{MIN_SNR_DB}), max err {err:.3e} (<= '
                                 f'{bound:.3e})')
        worst, max_err = min(worst, snr), max(max_err, err)
    return worst, max_err


def in_turns(fns, iters, warmup):
    """Mean ms of each named function over the turns plain, kernel,
    kernel, plain, and the peak device memory of each. ``warmup`` calls
    precede each turn; ``warmup=None``: one call of each before the first
    turn instead (for steps of seconds)."""
    if warmup is None:
        for fn in fns.values():
            fn()
        warmup = 0
    runs = {name: [] for name in fns}
    peak = {name: 0 for name in fns}
    for name in ('plain', 'kernel', 'kernel', 'plain'):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        runs[name].append(cuda_ms(fns[name], iters, warmup))
        peak[name] = max(peak[name], torch.cuda.max_memory_allocated())
    return {k: sum(v) / len(v) for k, v in runs.items()}, peak


GRID_PARAMS = 3_735_344
#: TF-GridNet's BLSTM scans at 16 x 4 s: (T, D, R, E, H)
LSTM_INTRA = (33, 2, 16 * 504, 128, 128)
LSTM_INTER = (126, 2, 16 * 132, 128, 128)
LSTM_NAMES = ('dx', 'dw_ih', 'db', 'dw_hh')
#: K3/K4 at the ends of K4's hidden sizes, R off the 32-row tile: (T, D, R,
#: E, H)
LSTM_EDGE_CASES = [(6, 2, 45, 36, 32), (4, 2, 300, 128, 256)]
@contextlib.contextmanager
def plain_lstms():
    """Every LSTM scan of the port runs the plain scan (forward and its
    memory-lean backward) instead of K3 and K4 or K5 and K6."""
    from brever_tpu_torch.models import rnn
    from brever_tpu_torch.ops import lstm_scan
    rnn.lstm_scan_x = lstm_scan.lstm_scan_x_plain
    rnn.lstm_scan = lstm_scan.lstm_scan_plain
    try:
        yield
    finally:
        rnn.lstm_scan_x = lstm_scan.lstm_scan_x
        rnn.lstm_scan = lstm_scan.lstm_scan


def lstm_inputs(rng, steps, n_dir, rows, feat, hidden, device='cuda'):
    arr = device_draws(rng, device)

    return (arr(steps, n_dir, rows, feat),
            arr(n_dir, feat, 4 * hidden, scale=hidden ** -0.5),
            arr(n_dir, 4 * hidden, scale=0.1),
            arr(n_dir, hidden, 4 * hidden, scale=hidden ** -0.5),
            arr(steps, n_dir, rows, hidden))


def wide_lstm_inputs(rng, steps, n_dir, rows, feat, hidden, device):
    """``lstm_inputs``' tensors with w_hh (D, H, 4H) drawn on the card from
    a generator seeded from ``rng`` (a numpy draw of 1 GB takes tens of
    seconds on the host)."""
    def arr(*s, scale=1.0):
        return torch.from_numpy((scale * rng.randn(*s)).astype(np.float32)) \
            .to(device)

    gen = torch.Generator(device=device).manual_seed(int(rng.randint(2 ** 31)))
    w_hh = torch.randn(n_dir, hidden, 4 * hidden, generator=gen,
                       device=device) * hidden ** -0.5
    return (arr(steps, n_dir, rows, feat),
            arr(n_dir, feat, 4 * hidden, scale=hidden ** -0.5),
            arr(n_dir, 4 * hidden, scale=0.1), w_hh,
            arr(steps, n_dir, rows, hidden))


def offset_view(t):
    """A copy of ``t`` one float into a larger buffer: contiguous, but not
    16-byte aligned, like a parameter in the trainer's flat buffer."""
    buf = t.new_empty(t.numel() + 1)
    buf[1:].copy_(t.reshape(-1))
    return buf[1:].view(t.shape)


def grid_model(params, device, dtype=torch.float32):
    from brever_tpu_torch.serve import build_model
    return build_model('tfgridnet', {}, params, device).to(dtype)


def grid_grads(model, batch, lengths):
    from brever_tpu_torch.models.base import sample_weighted_mean
    loss = sample_weighted_mean(model.loss(batch, lengths), lengths)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return {k: g.double().cpu().numpy()
            for (k, _), g in zip(model.named_parameters(), grads)}


def grad_report(ref, got):
    """(whole-gradient SNR, worst per-tensor SNR, its name, max error of
    the tensors whose reference is zero up to rounding) against float64."""
    top = max(float(np.abs(v).max()) for v in ref.values())
    live = {k for k in ref if np.abs(ref[k]).max() > 1e-6 * top}
    per = {k: snr_db(ref[k], got[k]) for k in live}
    worst = min(per, key=per.get)
    whole = snr_db(np.concatenate([ref[k].ravel() for k in ref]),
                   np.concatenate([got[k].ravel() for k in ref]))
    dead = max([float(np.abs(got[k] - ref[k]).max()) for k in ref
                if k not in live] + [0.0])
    return whole, per[worst], worst, dead / top


def tfgridnet_phases(device, card):
    """Phases 10-15; returns the numbers of the kernels' JSON records."""
    from brever_tpu_torch.checkpoint import load_checkpoint
    from brever_tpu_torch.models import ModelRegistry, count_params
    from brever_tpu_torch.ops import lstm_scan as lstm
    from brever_tpu_torch.profile_lstm import K4_PARTS, k4_parts
    from brever_tpu_torch.profile_train import make_trainer
    from brever_tpu_torch.serve import EnhanceService
    out = {}
    # cuFFT makes its plans with its own device allocations, which fail
    # (CUFFT_INTERNAL_ERROR) when PyTorch's allocator holds the card's
    # memory in its cache: hand the cache back between the large phases
    torch.cuda.empty_cache()

    # ---- phase 10: K3 and K4 vs their plain versions on the card
    rng = np.random.RandomState(10)
    cases = [LSTM_INTRA, LSTM_INTER, (7, 2, 1000, 72, 128),
             (1, 1, 33, 128, 128), *LSTM_EDGE_CASES]
    fwd_err, bwd_worst, bwd_err = 0.0, float('inf'), 0.0
    for n, case in enumerate(cases):
        name = 'T={} D={} R={} E={} H={}'.format(*case)
        x, w_ih, bias, w_hh, dh = lstm_inputs(rng, *case)
        if n == 2:  # weights at an unaligned offset, as in a flat buffer
            w_ih, w_hh = offset_view(w_ih), offset_view(w_hh)
        h, c = lstm.lstm_scan_x_fwd(x, w_ih, bias, w_hh)
        ref = lstm.lstm_scan_x_reference(x, w_ih, bias, w_hh)
        with torch.no_grad():
            h2, c2, gates = lstm.forward_gates(x, w_ih, bias, w_hh)
            gates4 = lstm.recompute_gates(x, w_ih, bias, w_hh, h)
        torch.cuda.synchronize()
        fwd_err = max(fwd_err, check_close(f'K3 {name}', ('h', 'c'), ref,
                                             (h, c))[1])
        if not (torch.equal(h, h2) and torch.equal(c, c2)):
            raise AssertionError(f'K3 {name}: two runs differ')
        if not torch.equal(gates, gates4):
            raise AssertionError(f'K3 {name}: K4\'s recomputed gates are '
                                 'not K3\'s')
        del ref, h2, c2, gates, gates4
        grads = lstm.lstm_scan_x_bwd(x, w_ih, bias, w_hh, h, c, dh)
        again = lstm.lstm_scan_x_bwd(x, w_ih, bias, w_hh, h, c, dh)
        f64 = [t.double() for t in (x, w_ih, bias, w_hh)]
        h64, c64 = lstm.lstm_scan_x_reference(*f64)
        ref = lstm.lstm_scan_x_bwd_plain(*f64, h64, c64, dh.double())
        del f64, h64, c64
        torch.cuda.synchronize()
        worst, err = check_close(f'K4 {name}', LSTM_NAMES, ref, grads)
        if not all(torch.equal(a, b) for a, b in zip(grads, again)):
            raise AssertionError(f'K4 {name}: two runs differ')
        bwd_worst, bwd_err = min(bwd_worst, worst), max(bwd_err, err)
        del ref, grads, again
    out['k3_err'], out['k4_err'] = fwd_err, bwd_err
    torch.cuda.empty_cache()
    phase(10, f'{len(cases)} scan cases (intra {LSTM_INTRA}, inter '
          f'{LSTM_INTER}, R=1000 E=72 with unaligned weights, T=1 D=1, '
          f'H=32 and H=256 at ragged R {[c[2] for c in LSTM_EDGE_CASES]}): '
          f'K3 h and c agree with the plain version (max abs err '
          f'{fwd_err:.3e}), two runs bitwise equal, and K4\'s recomputed '
          f'gates are bitwise K3\'s; K4 dx, dW_ih, db, '
          f'dW_hh with the plain backward in float64 (worst SNR '
          f'{bwd_worst:.1f} dB >= {MIN_SNR_DB}, max abs err {bwd_err:.3e}, '
          f'each <= {MAX_REL_ERR} x max|ref|); two runs bitwise equal')

    # ---- phase 11: enhance on the card vs the plain path in float64
    grid = ModelRegistry.get('tfgridnet')(device='cpu')
    grid.init_parameters(11)
    params = grid.to_flax(grid.state_dict())
    del grid
    with tempfile.TemporaryDirectory() as tmp:
        gpu = EnhanceService(write_model_dir(os.path.join(tmp, 'model'),
                                             'tfgridnet', params=params),
                             device)
    if count_params(gpu.model) != GRID_PARAMS:
        raise AssertionError(f'{count_params(gpu.model)} parameters')
    mix = (0.1 * np.random.RandomState(12).randn(4, 2, 4 * FS)) \
        .astype(np.float32)
    lstm.lstm_scan_x.launches = 0
    enhanced = gpu.model.enhance(mix)
    torch.cuda.synchronize()
    launches = lstm.lstm_scan_x.launches
    with plain_lstms():
        ref = grid_model(params, device, torch.float64).enhance(mix)
    snr, err = check_output('TF-GridNet enhance (4, 2, 64000)',
                            ref.cpu().numpy(), enhanced.cpu().numpy())
    if launches != 12:
        raise AssertionError(f'{launches} K3 launches, not 12')
    out['launches_serve'] = launches
    phase(11, f'TF-GridNet enhance (4, 2, 64000) on the card: SNR {snr:.2f} '
          f'dB, max abs err {err:.3e} vs the plain path in float64; '
          f'{launches} K3 launches')

    # ---- phase 12: full-model gradients vs the plain path in float64
    rng = np.random.RandomState(13)
    target = 0.1 * rng.randn(2, 1, 2, 2 * FS)
    batch = torch.from_numpy(np.concatenate(
        [target + 0.1 * rng.randn(2, 1, 2, 2 * FS), target], axis=1)
        .astype(np.float32)).to(device)
    lengths = torch.tensor([2 * FS, 3 * FS // 2], device=device)
    with plain_lstms():
        ref = grid_grads(grid_model(params, device, torch.float64),
                         batch.double(), lengths)
        plain = grid_grads(grid_model(params, device), batch, lengths)
    lstm.lstm_scan_x_bwd.launches = 0
    got = grid_grads(grid_model(params, device), batch, lengths)
    launches_bwd = lstm.lstm_scan_x_bwd.launches
    if launches_bwd != 12:
        raise AssertionError(f'{launches_bwd} K4 launches, not 12')
    k_whole, k_worst, k_name, k_dead = grad_report(ref, got)
    p_whole, p_worst, p_name, p_dead = grad_report(ref, plain)
    reserved = torch.cuda.memory_reserved() / 2 ** 30
    torch.cuda.empty_cache()
    if k_whole < GRID_WHOLE_DB or k_worst < GRID_TENSOR_DB \
            or k_dead > 1e-6:
        raise AssertionError(f'TF-GridNet gradients: whole {k_whole:.2f} '
                             f'dB, worst {k_name} {k_worst:.2f} dB, '
                             f'zero tensors {k_dead:.1e}')
    phase(12, f'TF-GridNet gradients (2 x 2 s, multiresyu) on the card vs '
          f'the plain path in float64: whole {k_whole:.1f} dB (>= '
          f'{GRID_WHOLE_DB}), worst tensor {k_worst:.1f} dB ({k_name}; >= '
          f'{GRID_TENSOR_DB}), zero-gradient tensors within {k_dead:.1e} '
          f'of the largest gradient; the plain float32 path: whole '
          f'{p_whole:.1f} dB, worst {p_worst:.1f} dB ({p_name}), zero '
          f'{p_dead:.1e}; {launches_bwd} K4 launches; {reserved:.1f} GiB '
          'reserved by the allocator before emptying its cache')

    # ---- phase 13: training through train.main on the card
    epochs = 12
    with tempfile.TemporaryDirectory() as tmp:
        model_dir = tone_model_dir(tmp, 'tfgridnet', 20)
        first, second, train_s, (out['launches_train'],
                                 out['launches_train_bwd']) = \
            train_and_resume(lambda n: train_args(model_dir, n, 4), epochs,
                             [(lstm.lstm_scan_x, 'launches'),
                              (lstm.lstm_scan_x_bwd, 'launches')])
        if not out['launches_train'] or not out['launches_train_bwd']:
            raise AssertionError('training launched K3 {} and K4 {} times'
                                 .format(out['launches_train'],
                                         out['launches_train_bwd']))
        losses = first.loss_logger.train_loss
        last = float(np.mean(losses[-3:]))
        if not np.isfinite(losses).all() or last > GRID_LOSS_RATIO * losses[0]:
            raise AssertionError(f'training loss {losses[0]:.4f} -> '
                                 f'{last:.4f}')
        trained = load_checkpoint(first.last_ckpt_path)['params']
        served = grid_model(trained, device)
        item = second.val_dataset[0][0][None]
        torch.testing.assert_close(served.enhance(item),
                                   second.model.enhance(item), atol=1e-6,
                                   rtol=1e-5)
        metrics = [m for m in first.loss_logger.metrics if m][-1]
        phase(13, f'TF-GridNet train.main, 24 x 1 s tone-in-noise WAV '
              f'items, batch 8, {epochs} epochs in {train_s:.1f} s: train '
              f'loss {losses[0]:.4f} -> {last:.4f} (multiresyu; <= '
              f'{GRID_LOSS_RATIO} x the first), val snr {metrics["snr"]:.2f}'
              f' sisnr {metrics["sisnr"]:.2f} dB; K3 '
              f'{out["launches_train"]} / K4 {out["launches_train_bwd"]} '
              f'launches; resumed bitwise (lr '
              f'{second.optimizer.learning_rate:g}) from last.ckpt to epoch '
              f'{second.epochs_ran}; the checkpoint serves')

        # ---- phase 14: the HTTP service over the model directory
        service = EnhanceService(model_dir, device)
        results = []
        lstm.lstm_scan_x.launches = lstm.lstm_scan.launches = 0
        with http_service(service) as (port, health):
            if health['params'] != GRID_PARAMS \
                    or health['arch'] != 'tfgridnet':
                raise AssertionError(f'/health: {health}')
            with plain_lstms():
                ref_model = grid_model(trained, device, torch.float64)
            # a 0.05 s request's intra scans have 8 rows, under the
            # 128-row floor: they take K5 (projection outside), as the JAX
            # package routes them; its inter scans (132 rows) take K3
            for seconds, want_k3, want_k5 in ((0.05, 6, 6), (4, 12, 0)):
                audio = (0.1 * np.random.RandomState(14).randn(
                    int(seconds * FS))).astype(np.float32)
                before = lstm.lstm_scan_x.launches, lstm.lstm_scan.launches
                got = post_wav(port, audio)
                launched = (lstm.lstm_scan_x.launches - before[0],
                            lstm.lstm_scan.launches - before[1])
                with plain_lstms():
                    want = ref_model.enhance(np.stack([audio, audio]))
                snr, _ = check_output(f'TF-GridNet /enhance {seconds} s',
                                      want.cpu().numpy(), got)
                if launched != (want_k3, want_k5):
                    raise AssertionError(
                        f'/enhance {seconds} s: K3 {launched[0]} and K5 '
                        f'{launched[1]} launches, not {want_k3} and '
                        f'{want_k5}')
                results.append(f'{seconds} s {snr:.1f} dB (K3 {launched[0]}'
                               f', K5 {launched[1]})')
        out['launches_http'] = lstm.lstm_scan_x.launches
        out['k5_launches_http'] = lstm.lstm_scan.launches
        phase(14, f'TF-GridNet /health ok, /enhance {", ".join(results)} '
              f'from EnhanceService(model_dir) on the trained last.ckpt vs '
              f'the plain path in float64; '
              f'{out["launches_http"]} K3 launches')
        del first, second, served, service, ref_model

    # ---- phase 15: timings (plain, kernel, kernel, plain in turns)
    torch.cuda.empty_cache()
    timing = {}
    for label, case in (('intra', LSTM_INTRA), ('inter', LSTM_INTER)):
        x, w_ih, bias, w_hh, dh = lstm_inputs(np.random.RandomState(15),
                                              *case)
        with torch.no_grad():
            h, c = lstm.lstm_scan_x_fwd(x, w_ih, bias, w_hh)
            fwd = in_turns({
                'kernel': lambda: lstm.lstm_scan_x_fwd(x, w_ih, bias, w_hh),
                'plain': lambda: lstm.lstm_scan_x_reference(x, w_ih, bias,
                                                            w_hh)}, 5, 2)[0]
            bwd = in_turns({
                'kernel': lambda: lstm.lstm_scan_x_bwd(x, w_ih, bias, w_hh,
                                                       h, c, dh),
                'plain': lambda: lstm.lstm_scan_x_bwd_plain(
                    x, w_ih, bias, w_hh, h, c, dh)}, 3, 1)[0]
            parts = k4_parts(lambda: lstm.lstm_scan_x_bwd(
                x, w_ih, bias, w_hh, h, c, dh))
        # the library's yardstick: cuDNN's LSTM, both directions over the
        # same (T, R, E) input, forward and backward (data and weights)
        steps, n_dir, rows, feat, hidden = case
        cudnn = torch.nn.LSTM(feat, hidden, bidirectional=n_dir == 2) \
            .to(device)
        xl = x[:, 0].clone().requires_grad_()
        with torch.no_grad():
            lib_fwd = cuda_ms(lambda: cudnn(xl), 5, 2)
        out_l, _ = cudnn(xl)
        dout = torch.randn_like(out_l)
        lib_bwd = cuda_ms(lambda: torch.autograd.grad(
            out_l, [xl, *cudnn.parameters()], dout, retain_graph=True), 3, 1)
        # bounds: gate products of every step (the backward recomputes
        # them, then dh W_hh^T, dx and dW); bytes of inputs and outputs
        flops = 2 * n_dir * steps * rows * 4 * hidden * (feat + hidden)
        weights = n_dir * 4 * hidden * (feat + hidden + 1)
        seq = steps * n_dir * rows
        seq_x, seq_h = seq * feat, seq * hidden
        timing[label] = {
            'fwd': fwd, 'bwd': bwd, 'lib_fwd': lib_fwd, 'lib_bwd': lib_bwd,
            'parts': parts,
            'fwd_plan': lstm.fwd_plan_info(steps, n_dir, rows, feat, hidden),
            'plan': lstm.plan_info(steps, n_dir, rows, feat, hidden),
            'bound_fwd': bound(flops, 4 * (seq_x + weights + 2 * seq_h)),
            'bound_bwd': bound(3 * flops, 4 * (2 * seq_x + 2 * weights
                                               + 3 * seq_h))}
        del x, w_ih, bias, w_hh, dh, h, c, cudnn, xl, out_l, dout
    batch = torch.from_numpy((0.1 * np.random.RandomState(16).randn(
        16, 2, 4 * FS)).astype(np.float32)).to(device)

    def plain_enhance():
        with plain_lstms():
            gpu.model.enhance(batch)

    # at 16 x 4 s every scan has 128 rows or more: 12 K3 launches, no K5
    lstm.lstm_scan_x.launches = lstm.lstm_scan.launches = 0
    gpu.model.enhance(batch)
    out['launches_16x4s'] = (lstm.lstm_scan_x.launches,
                             lstm.lstm_scan.launches)
    if out['launches_16x4s'] != (12, 0):
        raise AssertionError('TF-GridNet enhance 16 x 4 s: K3 {} and K5 {} '
                             'launches'.format(*out['launches_16x4s']))
    enhance_ms, enhance_peak = in_turns(
        {'kernel': lambda: gpu.model.enhance(batch), 'plain': plain_enhance},
        3, 1)
    del gpu, batch
    with tempfile.TemporaryDirectory() as tmp:
        step_trainer, data, n = make_trainer(device, tmp, arch='tfgridnet')

        def kernel_step():
            step_trainer.train_step(data, n)

        def plain_step():
            with plain_lstms():
                step_trainer.train_step(data, n)

        step_ms, step_peak = in_turns({'kernel': kernel_step,
                                       'plain': plain_step}, 2, 1)
        del step_trainer, data
    out.update(timing=timing, enhance_ms=enhance_ms, step_ms=step_ms)
    mib = 2 ** 20
    k4 = []
    for label in ('intra', 'inter'):
        parts, plan = timing[label]['parts'], timing[label]['plan']
        k4.append(f'{label} ' + ' '.join(f'{p} {parts[p]:.3f}'
                                         for p, *_ in K4_PARTS)
                  + f' (cuDNN {timing[label]["lib_bwd"]:.3f}); scan '
                  f'{2 * plan["tiles"]} blocks of {plan["threads"]} threads, '
                  f'{plan["rows"]} rows, {plan["smem"]} B; weight GEMM '
                  f'{plan["chunks"]} chunks of {plan["chunk"]} pairs')
    phase(15, f'[{card}] K4 launches ms: {"; ".join(k4)}')
    k3 = []
    for label in ('intra', 'inter'):
        plan = timing[label]['fwd_plan']
        k3.append(f'{label} {2 * plan["tiles"]} blocks of '
                  f'{plan["threads"]} threads, {plan["rows"]} rows, '
                  f'{plan["slice"]}-row slices, {plan["smem"]} B')
    phase(15, f'[{card}] K3 plan: ' + '; '.join(k3))
    phase(15, f'[{card}] BLSTM 16x4 s kernel/plain ms: intra K3 '
          f'{timing["intra"]["fwd"]["kernel"]:.3f}/'
          f'{timing["intra"]["fwd"]["plain"]:.3f} K4 '
          f'{timing["intra"]["bwd"]["kernel"]:.3f}/'
          f'{timing["intra"]["bwd"]["plain"]:.3f}, inter K3 '
          f'{timing["inter"]["fwd"]["kernel"]:.3f}/'
          f'{timing["inter"]["fwd"]["plain"]:.3f} K4 '
          f'{timing["inter"]["bwd"]["kernel"]:.3f}/'
          f'{timing["inter"]["bwd"]["plain"]:.3f}; cuDNN LSTM fwd/bwd intra '
          f'{timing["intra"]["lib_fwd"]:.3f}/{timing["intra"]["lib_bwd"]:.3f}'
          f', inter {timing["inter"]["lib_fwd"]:.3f}/'
          f'{timing["inter"]["lib_bwd"]:.3f}; TF-GridNet enhance 16x4 s '
          f'({out["launches_16x4s"][0]} K3, {out["launches_16x4s"][1]} K5 '
          f'launches) {enhance_ms["kernel"]:.2f} ms, peak '
          f'{enhance_peak["kernel"] / mib:.1f} MiB (plain LSTMs '
          f'{enhance_ms["plain"]:.2f} ms, {enhance_peak["plain"] / mib:.1f} '
          f'MiB); train step 16x4 s f32 {step_ms["kernel"]:.2f} ms, peak '
          f'{step_peak["kernel"] / mib:.1f} MiB (plain LSTMs '
          f'{step_ms["plain"]:.2f} ms, {step_peak["plain"] / mib:.1f} MiB)')
    return out


SGMSE_PARAMS = 65_590_694
#: K7 launches of one U-Net evaluation: sgmsep has 109 GroupNorms (105
#: with SiLU, the 4 of the attention blocks without), each one launch
SGMSE_EVAL_LAUNCHES = 109
#: K7/K8 cases (B, C, F, T) channels first, groups: the U-Net's largest
#: shapes at 4 x 4 s, then ragged ones (odd N, C = 384 with B = 1, G = C,
#: a rank-3 odd length, odd N past a cluster's shared memory); together
#: every route of the cluster plan (one block, a cluster holding the slab,
#: past it) with float4 and with 4-byte copies. GN_UNALIGNED runs with x
#: and dy one float past a 16-byte boundary
GN_CASES = [((4, 128, 256, 501), 32), ((4, 256, 256, 501), 32),
            ((4, 384, 128, 251), 32), ((4, 512, 64, 126), 32),
            ((4, 512, 4, 8), 32), ((1, 384, 7, 13), 32),
            ((2, 64, 33, 17), 64), ((3, 96, 1001), 24),
            ((2, 64, 255, 257), 2)]
GN_UNALIGNED = ((4, 384, 128, 251), 32)
#: SGMSE+'s bounds against float64 (phases 17-20) are 60 dB for the
#: denoiser, enhance, /enhance, the whole gradient and each gradient
#: tensor: the plain float32 path, printed beside, reaches 121 dB on the
#: denoiser, 125 dB on enhance (32 evaluations of the reverse SDE, one
#: generator seed on both paths) and 103 dB on its worst gradient tensor
#: (an H100 run of this script), so 60 dB keeps ~40 dB of margin above
#: float32's own drift and far below a wrong kernel. A short training
#: run's fixed-generator validation loss must end at most at
#: SGMSE_VAL_RATIO of the untrained model's: six epochs of 3 steps took it
#: to 0.70 on that run; the validation loss of fixed parameters is
#: deterministic, so only a training that does not learn misses the bound
SGMSE_VAL_RATIO = 0.9


@contextlib.contextmanager
def plain_groupnorms():
    """Every GroupNorm of the U-Net runs the plain forward and its
    memory-lean backward instead of K7 and K8."""
    from brever_tpu_torch.models.sgmse import net
    from brever_tpu_torch.ops import groupnorm
    net.group_norm_silu = groupnorm.group_norm_silu_plain
    try:
        yield
    finally:
        net.group_norm_silu = groupnorm.group_norm_silu


def device_draws(rng, device):
    """``arr(*shape, scale=1.0, center=0.0)``: float32 normal draws made on
    ``device`` from a generator seeded by ``rng`` (a numpy draw of the
    U-Net's and MANNER's largest tensors takes seconds on the host)."""
    gen = torch.Generator(device=device).manual_seed(
        int(rng.randint(2 ** 31)))

    def arr(*s, scale=1.0, center=0.0):
        return center + scale * torch.randn(*s, generator=gen, device=device)
    return arr


def gn_inputs(rng, shape, device='cuda'):
    arr = device_draws(rng, device)

    return (arr(*shape, scale=2.0, center=0.3), arr(shape[1], scale=0.1,
                                                    center=1.0),
            arr(shape[1], scale=0.1), arr(*shape))


def gn_bounds(shape, groups):
    """(K7, K8) bounds: bytes of x in and y out, of x and dy in and dx
    out (scale, bias, statistics and the affine's gradients are a few KB);
    ~10 flops an element (SiLU's exp counted as one) is far below them."""
    n = int(np.prod(shape))
    return bound(10 * n, 4 * 2 * n), bound(20 * n, 4 * 3 * n)


def library(x, scale, bias, groups, silu):
    """The PyTorch call of the same function: ``F.group_norm`` (+
    ``F.silu``), the library yardstick, never called by the port."""
    import torch.nn.functional as F
    y = F.group_norm(x, groups, scale, bias, 1e-6)
    return F.silu(y) if silu else y


def sgmse_model(state, device, dtype=torch.float32, arch='sgmsep'):
    """``arch`` (an SGMSE+ or IDMSE key) on ``device`` in ``dtype`` holding
    a state_dict."""
    from brever_tpu_torch.models import ModelRegistry
    model = ModelRegistry.get(arch)(device='cpu')
    model.load_state_dict(state)
    return model.to(device=device, dtype=dtype).eval()


def complex_input(rng, shape, device, scale=0.3):
    return torch.complex(*(torch.from_numpy((scale * rng.randn(*shape))
                                            .astype(np.float32))
                           for _ in range(2))).to(device)


def sgmse_grads(model, batch, lengths, t, noise):
    from brever_tpu_torch.models.base import sample_weighted_mean
    model.train()
    dtype = model.net.input_conv.weight.dtype
    cdtype = torch.complex128 if dtype == torch.float64 else torch.complex64
    loss = sample_weighted_mean(model.loss_at(
        batch.to(dtype), lengths, t.to(dtype), noise.to(cdtype)), lengths)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    model.eval()
    return {k: g.double().cpu().numpy()
            for (k, _), g in zip(model.named_parameters(), grads)}


#: Run in a fresh interpreter (the profiler loses events after several
#: traces in one process): one K7 call and one K8 call at each route of the
#: plan (one block, a cluster holding the slab, past it), one trace each;
#: prints the device kernels' names
GN_TRACE = """
import json
import torch
from brever_tpu_torch.numerics import disable_tf32
from brever_tpu_torch.ops import groupnorm as gn

disable_tf32()
dev = torch.device('cuda', 0)
gen = torch.Generator(device=dev).manual_seed(21)
cases = []
for shape in ((4, 256, 16, 32), (4, 384, 128, 251), (4, 256, 256, 501)):
    x, dy = (torch.randn(*shape, generator=gen, device=dev)
             for _ in range(2))
    scale = 1 + 0.1 * torch.randn(shape[1], generator=gen, device=dev)
    bias = 0.1 * torch.randn(shape[1], generator=gen, device=dev)
    with torch.no_grad():
        _, mean, rstd = gn.group_norm_act_fwd(x, scale, bias, 32, 1e-6,
                                              'silu')
    cases.append((x, dy, scale, bias, mean, rstd))


def names(fn):
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    # a trace without one device event lost its events (seen on the card
    # once in many runs), as the calls launch kernels: trace them again
    for _ in range(3):
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        got = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        if got:
            break
    return got


with torch.no_grad():
    out = {'routes': [gn.plan_info(c[0].shape[0], c[0].shape[1],
                                   c[0][0, 0].numel(), 32)['route']
                      for c in cases],
           'k7': names(lambda: [gn.group_norm_act_fwd(x, s, b, 32, 1e-6,
                                                      'silu')
                                for x, _, s, b, _, _ in cases]),
           'k8': names(lambda: [gn.group_norm_act_bwd(x, d, s, b, m, r, 32,
                                                      'silu')
                                for x, d, s, b, m, r in cases])}
print(json.dumps(out))
"""


def gn_launches_a_call():
    """``{'k7': n, 'k8': n}``: the kernels one K7 call and one K8 call
    launch, counted in a trace of one call at each route in a fresh
    interpreter; fails unless K7 launches ``gn_fwd_cluster`` alone and K8
    ``gn_bwd_cluster`` and ``gn_bwd_channels``, once a call each."""
    root = os.path.dirname(os.path.abspath(__file__))
    run = subprocess.run([sys.executable, '-c', GN_TRACE], cwd=root,
                         env=dict(os.environ, PYTHONPATH=root),
                         capture_output=True, text=True, timeout=600)
    if run.returncode:
        raise AssertionError(f'K7/K8 trace: {run.stderr[-3000:]}')
    traced = json.loads(run.stdout.strip().splitlines()[-1])
    if sorted(traced['routes']) != ['block', 'cluster', 'partial']:
        raise AssertionError(f'K7/K8 trace routes: {traced["routes"]}')
    calls = len(traced['routes'])
    want = {'k7': ['gn_fwd_cluster'],
            'k8': ['gn_bwd_cluster', 'gn_bwd_channels']}
    out = {}
    for key, kernels in want.items():
        names = traced[key]
        if len(names) % calls or any(
                sum(k in n for n in names) != calls for k in kernels) or len(
                names) != calls * len(kernels):
            raise AssertionError(f'{key} launched {names} in {calls} calls')
        out[key] = len(names) // calls
    return out


def sgmse_phases(device, card):
    """Phases 16-21; returns the numbers of the K7/K8 JSON records."""
    from brever_tpu_torch.checkpoint import load_checkpoint
    from brever_tpu_torch.models import ModelRegistry, count_params
    from brever_tpu_torch.ops import groupnorm as gn
    from brever_tpu_torch.profile_train import make_trainer
    from brever_tpu_torch.serve import EnhanceService
    out = {}
    torch.cuda.empty_cache()
    k7, k8 = gn.group_norm_act_fwd, gn.group_norm_act_bwd

    # ---- phase 16: K7 and K8 vs their plain versions on the card
    rng = np.random.RandomState(16)
    fwd_worst, fwd_err, bwd_worst, bwd_err, n_cases = (float('inf'), 0.0,
                                                       float('inf'), 0.0, 0)
    routes = set()   # (route, float4 copies) of K7 and K8's one plan
    cases = [(shape, groups, False) for shape, groups in GN_CASES]
    for shape, groups, unaligned in cases + [(*GN_UNALIGNED, True)]:
        acts = ('silu', 'none') + (('relu',) if groups == shape[1] else ())
        n = int(np.prod(shape[2:]))
        routes.add((gn.plan_info(shape[0], shape[1], n, groups)['route'],
                    n % 4 == 0 and not unaligned))
        for act in acts:
            name = f'{shape} G={groups} {act}' + (' unaligned' * unaligned)
            x, scale, bias, dy = gn_inputs(rng, shape)
            if unaligned:
                x, dy = offset_view(x), offset_view(dy)
            y, mean, rstd = k7(x, scale, bias, groups, 1e-6, act)
            again = k7(x, scale, bias, groups, 1e-6, act)
            if not all(torch.equal(a, b)
                       for a, b in zip((y, mean, rstd), again)):
                raise AssertionError(f'K7 {name}: two runs differ')
            del again
            ref = gn.group_norm_act_reference(x, scale, bias, groups, 1e-6,
                                              act)
            worst, err = check_close(f'K7 {name}', ('y', 'mean', 'rstd'),
                                     ref, (y, mean, rstd))
            fwd_worst, fwd_err = min(fwd_worst, worst), max(fwd_err, err)
            del ref
            grads = k8(x, dy, scale, bias, mean, rstd, groups, act)
            again = k8(x, dy, scale, bias, mean, rstd, groups, act)
            if not all(torch.equal(a, b) for a, b in zip(grads, again)):
                raise AssertionError(f'K8 {name}: two runs differ')
            del again
            # ReLU's branch at a z within rounding of 0 is the kernel's
            dy64, act64 = ((dy * (y > 0)).double(), 'none') \
                if act == 'relu' else (dy.double(), act)
            want = gn.group_norm_act_bwd_plain(
                x.double(), dy64, scale.double(), bias.double(),
                mean.double(), rstd.double(), groups, act64)
            worst, err = check_close(f'K8 {name}', ('dx', 'dscale', 'dbias'),
                                     want, grads)
            bwd_worst, bwd_err = min(bwd_worst, worst), max(bwd_err, err)
            n_cases += 1
            del x, y, dy, dy64, grads, want
    torch.cuda.empty_cache()
    every = {(route, vec) for route in ('block', 'cluster', 'partial')
             for vec in (True, False)}
    if routes != every:
        raise AssertionError(f'K7/K8 routes run: {routes}')
    out['k7_err'], out['k8_err'] = fwd_err, bwd_err
    phase(16, f'{n_cases} GroupNorm cases (the U-Net\'s (4, C, F, T) shapes '
          f'at 4 x 4 s, odd N, C=384 B=1, G=C with ReLU, unaligned), every '
          f'route of the cluster plan (one block, a cluster holding the '
          f'slab, past it) with float4 and 4-byte copies for K7 and K8: K7 '
          f'y, mean, rstd vs the plain version worst {fwd_worst:.1f} dB, max '
          f'abs err {fwd_err:.3e}; K8 dx, dscale, dbias vs the plain '
          f'backward in float64 worst {bwd_worst:.1f} dB (>= {MIN_SNR_DB}), '
          f'max abs err {bwd_err:.3e} (each <= {MAX_REL_ERR} x max|ref|); '
          'two K7 runs and two K8 runs bitwise equal')

    # ---- phase 17: the denoiser and enhance vs the plain path in float64
    model = ModelRegistry.get('sgmsep')(device='cpu')
    model.init_parameters(17)
    state = model.state_dict()
    params, aux = model.to_flax(state), model.flax_aux(state)
    del model
    with tempfile.TemporaryDirectory() as tmp:
        gpu = EnhanceService(write_model_dir(os.path.join(tmp, 'model'),
                                             'sgmsep', params=params,
                                             aux=aux), device)
    if count_params(gpu.model) != SGMSE_PARAMS:
        raise AssertionError(f'{count_params(gpu.model)} parameters')
    rng = np.random.RandomState(17)
    xs, ys = (complex_input(rng, (2, 1, 256, 501), device) for _ in range(2))
    t = torch.tensor([0.35, 0.8], device=device).reshape(2, 1, 1, 1)
    sigma = gpu.model.sde.sigma(t)
    ref64 = sgmse_model(state, device, torch.float64)
    plain32 = sgmse_model(state, device)
    with torch.no_grad():
        k7.launches = 0
        got = gpu.model.model(xs, ys, sigma, t)
        torch.cuda.synchronize()
        per_eval = k7.launches   # one evaluation of a batch of 2
        with plain_groupnorms():
            want = ref64.model(xs.to(torch.complex128),
                               ys.to(torch.complex128), sigma.double(),
                               t.double())
            plain = plain32.model(xs, ys, sigma, t)
    if per_eval != SGMSE_EVAL_LAUNCHES:
        raise AssertionError(f'{per_eval} K7 launches an evaluation, not '
                             f'{SGMSE_EVAL_LAUNCHES}')
    den_db, den_err = check_close('denoiser (2, 1, 256, 501)', ('d',),
                                  (torch.view_as_real(want),),
                                  (torch.view_as_real(got),))
    den_plain_db = check_close('plain denoiser', ('d',),
                               (torch.view_as_real(want),),
                               (torch.view_as_real(plain),), 0.0, None)[0]
    del got, want, plain
    mix = (0.3 * np.random.RandomState(18).randn(1, 2, 2 * FS)) \
        .astype(np.float32)

    def enhance(model):
        return model.enhance(mix, generator=torch.Generator(device=device)
                             .manual_seed(0))

    k7.launches = 0
    got = enhance(gpu.model)
    torch.cuda.synchronize()
    enh_launches = k7.launches
    with plain_groupnorms():
        want, plain = enhance(ref64), enhance(plain32)
    enh_plain_db = check_close('plain enhance', ('wav',), (want,), (plain,),
                               0.0, None)[0]
    enh_db, enh_err = check_close('enhance (1, 2, 32000)', ('wav',),
                                  (want,), (got,))
    evals = gpu.model.solver.evaluations   # U-Net evaluations a call
    if enh_launches != evals * SGMSE_EVAL_LAUNCHES:
        raise AssertionError(f'enhance: {enh_launches} K7 launches, not '
                             f'{evals} x {SGMSE_EVAL_LAUNCHES}')
    out['launches_eval'] = SGMSE_EVAL_LAUNCHES
    del ref64, plain32, got, want, plain
    torch.cuda.empty_cache()
    phase(17, f'SGMSE+ ({SGMSE_PARAMS:,} parameters) from '
          f'EnhanceService(model_dir): denoiser (2 x 4 s) {den_db:.1f} dB, '
          f'max abs err {den_err:.3e} vs the plain path in float64 (plain '
          f'float32 {den_plain_db:.1f} dB), {per_eval:.0f} K7 launches an '
          f'evaluation; enhance (1 x 2 s, {evals} evaluations, generator '
          f'seed 0 on both paths) {enh_db:.1f} dB (plain float32 '
          f'{enh_plain_db:.1f} dB; >= {MIN_SNR_DB}), {enh_launches} K7 '
          'launches')

    # ---- phase 18: full-model gradients vs the plain path in float64
    rng = np.random.RandomState(19)
    target = 0.1 * rng.randn(2, 1, 2, 2 * FS)
    batch = torch.from_numpy(np.concatenate(
        [target + 0.1 * rng.randn(2, 1, 2, 2 * FS), target], axis=1)
        .astype(np.float32)).to(device)
    lengths = torch.tensor([2 * FS, 3 * FS // 2], device=device)
    t = torch.tensor([0.3, 0.9], device=device).reshape(2, 1, 1, 1)
    frames = gpu.model.transform(batch).shape[-1]
    noise = complex_input(rng, (2, 1, 256, frames), device, 1.0)
    with plain_groupnorms():
        ref = sgmse_grads(sgmse_model(state, device, torch.float64), batch,
                          lengths, t, noise)
        plain = sgmse_grads(sgmse_model(state, device), batch, lengths, t,
                            noise)
    k8.launches = k7.recompute_launches = 0
    got = sgmse_grads(gpu.model, batch, lengths, t, noise)
    launches_bwd, recomputes = k8.launches, k7.recompute_launches
    if launches_bwd != SGMSE_EVAL_LAUNCHES:
        raise AssertionError(f'{launches_bwd} K8 launches, not '
                             f'{SGMSE_EVAL_LAUNCHES}')
    k_whole, k_worst, k_name, k_dead = grad_report(ref, got)
    p_whole, p_worst, p_name, p_dead = grad_report(ref, plain)
    del ref, plain, got
    torch.cuda.empty_cache()
    if k_whole < MIN_SNR_DB or k_worst < MIN_SNR_DB or k_dead > 1e-6:
        raise AssertionError(f'SGMSE+ gradients: whole {k_whole:.2f} dB, '
                             f'worst {k_name} {k_worst:.2f} dB, zero '
                             f'tensors {k_dead:.1e}')
    phase(18, f'SGMSE+ gradients (2 x 2 s, t and noise fixed, remat) vs the '
          f'plain path in float64: whole {k_whole:.1f} dB (>= {MIN_SNR_DB}),'
          f' worst tensor {k_worst:.1f} dB ({k_name}; >= {MIN_SNR_DB}), '
          f'zero-gradient tensors within {k_dead:.1e} of the largest; the '
          f'plain float32 path: whole {p_whole:.1f} dB, worst '
          f'{p_worst:.1f} dB ({p_name}), zero {p_dead:.1e}; {launches_bwd} '
          f'K8 launches, {recomputes} K7 recomputes of rematerialised '
          'blocks')

    # ---- phase 19: training through train.main on the card
    from brever_tpu_torch import train
    epochs = 4   # the smoke's time limit: 6 before the bf16 phases
    with tempfile.TemporaryDirectory() as tmp:
        model_dir = tone_model_dir(tmp, 'sgmsep', 30)

        def args(n):   # validation scores the loss alone: SGMSE+'s
            return train_args(model_dir, n, 1, '')   # enhance is 32 evals

        untrained = train.build_trainer(args(epochs))
        untrained.init_state()
        untrained.val_dataloader.set_epoch(0)
        val_0, _ = untrained.routine(0, train=False)
        del untrained
        first, second, train_s, (out['launches_train'],
                                 out['launches_train_bwd'],
                                 out['recompute_train']) = \
            train_and_resume(args, epochs, [(k7, 'launches'),
                                            (k8, 'launches'),
                                            (k7, 'recompute_launches')])
        if not out['launches_train'] or not out['launches_train_bwd']:
            raise AssertionError('training launched K7 {} and K8 {} times'
                                 .format(out['launches_train'],
                                         out['launches_train_bwd']))
        val = [v for v in first.loss_logger.val_loss if v is not None]
        losses = first.loss_logger.train_loss
        if not np.isfinite(val + losses).all() \
                or val[-1] > SGMSE_VAL_RATIO * val_0:
            raise AssertionError(f'validation loss {val_0:.4f} -> {val}')
        state_ckpt = load_checkpoint(second.last_ckpt_path)
        if not np.array_equal(
                state_ckpt['aux']['buffers']['emb']['fourier_freqs'],
                second.model.net.emb.fourier_freqs.cpu().numpy()) \
                or 'torch_generator' not in state_ckpt:
            raise AssertionError('last.ckpt lacks aux or the generator')
        phase(19, f'SGMSE+ train.main, 24 x 1 s tone-in-noise WAV items, '
              f'batch 8, {epochs} epochs in {train_s:.1f} s: fixed-generator'
              f' validation loss {val_0:.4f} (untrained) -> '
              f'{", ".join(f"{v:.4f}" for v in val)} (last <= '
              f'{SGMSE_VAL_RATIO} x untrained); train loss (t drawn anew '
              f'each step) {", ".join(f"{v:.3f}" for v in losses)}; K7 '
              f'{out["launches_train"]} (of them '
              f'{out["recompute_train"]} recomputes) / K8 '
              f'{out["launches_train_bwd"]} launches; resumed bitwise from '
              f'last.ckpt (aux, generator state) to epoch '
              f'{second.epochs_ran}')

        # ---- phase 20: the HTTP service over the model directory
        service = EnhanceService(model_dir, device)
        ref_model = sgmse_model(service.model.state_dict(), device,
                                torch.float64)
        results = []
        k7.launches = 0
        with http_service(service) as (port, health):
            if health['params'] != SGMSE_PARAMS or health['arch'] != 'sgmsep':
                raise AssertionError(f'/health: {health}')
            for seconds in (0.05, 1):
                audio = (0.1 * np.random.RandomState(20).randn(
                    int(seconds * FS))).astype(np.float32)
                before = k7.launches
                got = post_wav(port, audio)
                launched = k7.launches - before
                with plain_groupnorms():
                    want = ref_model.enhance(
                        np.stack([audio, audio]),
                        generator=torch.Generator(device=device)
                        .manual_seed(0))
                db, _ = check_close(f'SGMSE+ /enhance {seconds} s', ('wav',),
                                    (want,), (torch.from_numpy(got)
                                              .to(device),))
                if launched != evals * SGMSE_EVAL_LAUNCHES:
                    raise AssertionError(f'/enhance {seconds} s: {launched} '
                                         'K7 launches')
                results.append(f'{seconds} s {db:.1f} dB')
        out['launches_http'] = k7.launches
        phase(20, f'SGMSE+ /health ok, /enhance {", ".join(results)} from '
              f'EnhanceService(model_dir) on the trained last.ckpt (aux '
              f'included) vs the plain path in float64 (generator seed 0); '
              f'{out["launches_http"]} K7 launches')
        del first, second, service, ref_model
    torch.cuda.empty_cache()

    # ---- phase 21: timings (plain, kernel, kernel, plain in turns)
    from brever_tpu_torch.bench_alu_dtype import time_calls
    from brever_tpu_torch.bench_groupnorm import time_unet_calls, unet_calls
    x, scale, bias, dy = gn_inputs(np.random.RandomState(21),
                                   GN_CASES[1][0])
    with torch.no_grad():
        _, mean, rstd = k7(x, scale, bias, 32, 1e-6, 'silu')
        calls = {
            'fwd': lambda: k7(x, scale, bias, 32, 1e-6, 'silu'),
            'bwd': lambda: k8(x, dy, scale, bias, mean, rstd, 32, 'silu')}
        fwd = in_turns({
            'kernel': calls['fwd'],
            'plain': lambda: gn.group_norm_act_reference(
                x, scale, bias, 32, 1e-6, 'silu')}, 10, 2)[0]
        bwd = in_turns({
            'kernel': calls['bwd'],
            'plain': lambda: gn.group_norm_act_bwd_plain(
                x, dy, scale, bias, mean, rstd, 32, 'silu')}, 10, 2)[0]
        fwd['library'] = cuda_ms(lambda: library(x, scale, bias, 32, True),
                                 10, 2)
        # the card's time (calls queued behind a sleep kernel) and the
        # host's a call
        for key, times in (('fwd', fwd), ('bwd', bwd)):
            times['card'], times['host'] = time_calls(calls[key], device, 20)
    leaves = [t.clone().requires_grad_() for t in (x, scale, bias)]
    y_lib = library(*leaves, 32, True)
    bwd['library'] = cuda_ms(lambda: torch.autograd.grad(
        y_lib, leaves, dy, retain_graph=True), 10, 2)
    del x, dy, mean, rstd, leaves, y_lib, calls
    out['largest'] = {'fwd': fwd, 'bwd': bwd,
                      'bound': gn_bounds(GN_CASES[1][0], 32)}
    # the kernels a K7 and a K8 call launch at each route, traced in a
    # fresh interpreter
    out['launches_a_call'] = gn_launches_a_call()
    # one U-Net evaluation at 4 x 4 s: its GroupNorm calls, each timed
    rng = np.random.RandomState(22)
    xs, ys = (complex_input(rng, (4, 1, 256, 501), device) for _ in range(2))
    t = torch.full((4, 1, 1, 1), 0.5, device=device)
    sigma = gpu.model.sde.sigma(t)
    calls = unet_calls(gpu.model, device)
    # K7 and K8 on the card, as issued and from the host, then the plain
    # versions and the library's calls
    kernels = time_unet_calls(calls, device)
    per_eval = dict(kernels['sum'], k7=kernels['sum']['k7_paced'],
                    k8=kernels['sum']['k8_paced'])
    per_eval.update({k: 0.0 for k in ('plain', 'library', 'plain_bwd',
                                      'library_bwd')})
    for (shape, groups, silu), count in calls.items():
        act = 'silu' if silu else 'none'
        x, scale, bias, dy = gn_inputs(rng, shape)
        with torch.no_grad():
            _, mean, rstd = k7(x, scale, bias, groups, 1e-6, act)
            times = {
                'plain': lambda: gn.group_norm_act_reference(
                    x, scale, bias, groups, 1e-6, act),
                'library': lambda: library(x, scale, bias, groups, silu),
                'plain_bwd': lambda: gn.group_norm_act_bwd_plain(
                    x, dy, scale, bias, mean, rstd, groups, act)}
            for key, fn in times.items():
                per_eval[key] += count * cuda_ms(fn, 5, 1)
        leaves = [v.clone().requires_grad_() for v in (x, scale, bias)]
        y_lib = library(*leaves, groups, silu)
        per_eval['library_bwd'] += count * cuda_ms(
            lambda: torch.autograd.grad(y_lib, leaves, dy,
                                        retain_graph=True), 5, 1)
        del x, dy, mean, rstd, leaves, y_lib
    n_calls = sum(calls.values())
    if n_calls != SGMSE_EVAL_LAUNCHES:
        raise AssertionError(f'{n_calls} GroupNorm calls an evaluation')
    out['eval'] = per_eval
    out['eval_rows'] = kernels['rows']

    def plain(fn):
        def run():
            with plain_groupnorms():
                fn()
        return run

    def denoise():
        with torch.no_grad():
            gpu.model.model(xs, ys, sigma, t)

    den_ms, den_peak = in_turns({'kernel': denoise, 'plain': plain(denoise)},
                                1, None)
    # 1 x 2 s (the smoke's time limit: 1 x 4 s before the bf16 phases)
    mix = torch.from_numpy((0.1 * rng.randn(1, 2, 2 * FS))
                           .astype(np.float32)).to(device)

    def enhance_2s():
        gpu.model.enhance(mix)

    # one call each (32 U-Net evaluations, ~9 s with the plain
    # GroupNorms): turns would double the smoke's longest phase
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    enh_ms = {'kernel': cuda_ms(enhance_2s, 1, 0)}
    enh_peak = {'kernel': torch.cuda.max_memory_allocated()}
    enh_ms['plain'] = cuda_ms(plain(enhance_2s), 1, 0)
    del gpu, xs, ys, mix
    torch.cuda.empty_cache()
    steps = {}
    with tempfile.TemporaryDirectory() as tmp:
        step_trainer, data, n = make_trainer(device, tmp, batch=4,
                                             arch='sgmsep')

        def step():
            step_trainer.train_step(data, n)

        steps['4'] = in_turns({'kernel': step, 'plain': plain(step)}, 1,
                              None)
        del step_trainer, data, n
        torch.cuda.empty_cache()
        # 8 x 4 s (the smoke's time limit: 16 x 4 s before the norms'
        # bf16 phases)
        try:
            step_trainer, data, n = make_trainer(device, tmp, batch=8,
                                                 arch='sgmsep')
            torch.cuda.reset_peak_memory_stats()
            ms8 = cuda_ms(step, 1, 1)
            steps['8'] = (ms8, torch.cuda.max_memory_allocated())
        except torch.cuda.OutOfMemoryError as e:
            steps['8'] = (None, str(e).splitlines()[0])
        step_trainer = data = n = None
    torch.cuda.empty_cache()
    out.update(den_ms=den_ms, enh_ms=enh_ms, steps=steps)
    mib = 2 ** 20
    (s4_ms, s4_peak), (s8_ms, s8_peak) = steps['4'], steps['8']
    big = (f'{s8_ms:.1f} ms, peak {s8_peak / mib:.1f} MiB'
           if s8_ms is not None else f'did not fit ({s8_peak})')
    shapes = '; '.join(
        f'{tuple(r["shape"])}{"" if r["act"] == "silu" else " none"} x'
        f'{r["count"]} {r["route"]}/{r["cluster"]} K7 '
        f'{r["k7"]["card"]:.4f}, K8 {r["k8"]["card"]:.4f}'
        for r in out['eval_rows'])
    launched = out['launches_a_call']
    phase(21, f'[{card}] K7/K8 at (4, 256, 256, 501) kernel/plain/'
          f'F.group_norm+F.silu ms: fwd {fwd["kernel"]:.3f}/'
          f'{fwd["plain"]:.3f}/{fwd["library"]:.3f} (card {fwd["card"]:.3f},'
          f' host {fwd["host"]:.4f} a call; bound '
          f'{out["largest"]["bound"][0][0]:.3f}), bwd {bwd["kernel"]:.3f}/'
          f'{bwd["plain"]:.3f}/{bwd["library"]:.3f} (card {bwd["card"]:.3f}, '
          f'host {bwd["host"]:.4f}; bound '
          f'{out["largest"]["bound"][1][0]:.3f}); kernels a call (a trace '
          f'in a fresh interpreter, one call at each route): K7 '
          f'{launched["k7"]}, K8 {launched["k8"]}; summed over the '
          f'{n_calls} GroupNorms of one evaluation at 4 x 4 s, paced/'
          f'plain/library: K7 {per_eval["k7"]:.2f}/{per_eval["plain"]:.2f}/'
          f'{per_eval["library"]:.2f} (card {per_eval["k7_card"]:.2f}, host '
          f'{per_eval["k7_host"]:.4f} a call; bound '
          f'{per_eval["bound_k7"]:.2f}), K8 {per_eval["k8"]:.2f}/'
          f'{per_eval["plain_bwd"]:.2f}/{per_eval["library_bwd"]:.2f} (card '
          f'{per_eval["k8_card"]:.2f}, host {per_eval["k8_host"]:.4f}; bound '
          f'{per_eval["bound_k8"]:.2f}); route/cluster and card ms by shape: '
          f'{shapes}; denoiser 4 x 4 s {den_ms["kernel"]:.2f} ms, peak '
          f'{den_peak["kernel"] / mib:.1f} MiB (plain GroupNorms '
          f'{den_ms["plain"]:.2f} ms, {den_peak["plain"] / mib:.1f} MiB); '
          f'enhance 1 x 2 s {enh_ms["kernel"]:.1f} ms, peak '
          f'{enh_peak["kernel"] / mib:.1f} MiB (plain {enh_ms["plain"]:.1f} '
          f'ms); train step 4 x 4 s f32 {s4_ms["kernel"]:.1f} ms, peak '
          f'{s4_peak["kernel"] / mib:.1f} MiB (plain GroupNorms '
          f'{s4_ms["plain"]:.1f} ms, {s4_peak["plain"] / mib:.1f} MiB); '
          f'train step 8 x 4 s {big}')
    return out


DCCRN_PARAMS = 3_671_053
#: DCCRN's complex-LSTM scans at 16 x 4 s, (T, D, R, E, H) of its two
#: layers: 495 frames, the real and imaginary weight sets, 2B rows
DCCRN_LSTM = ((495, 2, 32, 512, 128), (495, 2, 32, 128, 128))
#: K5/K6 cases (T, D, R, E, H), gates_x = x w_ih + bias: DCCRN's two
#: complex-LSTM layers at 16 x 4 s (R = 2B = 32) and its first at B = 1,
#: TF-GridNet's intra scan of a 0.05 s request (T = 33 bands, R = 8 frames),
#: then H 32..256 with T = 1 and D = 1 and 2; SCAN_UNALIGNED takes its w_hh
#: and gates_x at an offset that is not 16-byte aligned
SCAN_CASES = [*DCCRN_LSTM, (495, 2, 2, 512, 128), (33, 2, 8, 128, 128),
              (1, 1, 5, 64, 32), (1, 2, 7, 64, 64), (1, 1, 33, 32, 128),
              (1, 2, 3, 16, 256), (9, 2, 40, 72, 64)]
SCAN_UNALIGNED = 8
#: a short DCCRN training run's train loss (negated SNR, dB) must fall by
#: more than this from its first epoch to the mean of its last three
DCCRN_LOSS_DROP = 0.5


def dccrn_model(state, device, dtype=torch.float32):
    """The default ``dccrn`` on ``device`` in ``dtype`` holding a
    state_dict (running statistics included), in eval mode."""
    from brever_tpu_torch.models import ModelRegistry
    model = ModelRegistry.get('dccrn')(device='cpu')
    model.load_state_dict(state)
    return model.to(device=device, dtype=dtype).eval()


def dccrn_grads(model, batch, lengths):
    """Gradients of the train-mode loss (a float64 model gets a float64
    batch), and the running statistics that loss left."""
    from brever_tpu_torch.models.base import sample_weighted_mean
    model.train()
    dtype = model.lstm_proj_real.weight.dtype
    loss = sample_weighted_mean(model.loss(batch.to(dtype), lengths),
                                lengths)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    model.eval()
    return ({k: g.double().cpu().numpy()
             for (k, _), g in zip(model.named_parameters(), grads)},
            {k: b.detach().clone() for k, b in model.named_buffers()})


def scan_cluster_record(timing, which='fwd'):
    """The ``cluster`` entry of K5's (``fwd``) or K6's (``bwd``) record at
    DCCRN's shape (T = 495, H = 128): blocks a cluster, threads and shared
    memory a block, and us a step of phase 27's kernel time."""
    from brever_tpu_torch.ops.lstm_scan import cluster_info
    info = cluster_info(128)
    return {'blocks': info['blocks'], 'threads_per_block': info['threads'],
            'smem_bytes': info[f'smem_{which}'],
            'us_per_step': 1e3 * timing['layer0'][which]['kernel'] / 495}


def dccrn_phases(device, card):
    """Phases 22-27; returns the numbers of the K5/K6 JSON records."""
    from brever_tpu_torch.checkpoint import load_checkpoint
    from brever_tpu_torch.models import ModelRegistry, count_params
    from brever_tpu_torch.ops import lstm_scan as lstm
    from brever_tpu_torch.profile_train import make_trainer
    from brever_tpu_torch.serve import EnhanceService, build_model
    out = {}
    torch.cuda.empty_cache()
    k5, k6 = lstm.lstm_scan, lstm.lstm_scan_bwd

    # ---- phase 22: K5 and K6 vs their plain versions on the card
    rng = np.random.RandomState(22)
    fwd_worst, fwd_err, bwd_worst, bwd_err = (float('inf'), 0.0,
                                              float('inf'), 0.0)
    fwd64 = float('inf')
    for n, case in enumerate(SCAN_CASES):
        name = 'T={} D={} R={} E={} H={}'.format(*case)
        x, w_ih, bias, w_hh, dh = lstm_inputs(rng, *case)
        gates_x = (torch.einsum('tdre,dek->tdrk', x, w_ih)
                   + bias[None, :, None]).contiguous()
        del x, w_ih, bias
        if n == SCAN_UNALIGNED:   # at an unaligned offset, as in a flat
            gates_x, w_hh = offset_view(gates_x), offset_view(w_hh)  # buffer
        h, c = lstm.lstm_scan_fwd(gates_x, w_hh)
        h2, c2 = lstm.lstm_scan_fwd(gates_x, w_hh)
        ref = lstm.lstm_scan_reference(gates_x, w_hh)
        torch.cuda.synchronize()
        if not (torch.equal(h, h2) and torch.equal(c, c2)):
            raise AssertionError(f'K5 {name}: two runs differ')
        worst, err = check_close(f'K5 {name}', ('h', 'c'), ref, (h, c))
        fwd_worst, fwd_err = min(fwd_worst, worst), max(fwd_err, err)
        del ref, h2, c2
        grads = lstm.lstm_scan_bwd(gates_x, w_hh, h, c, dh)
        again = lstm.lstm_scan_bwd(gates_x, w_hh, h, c, dh)
        if not all(torch.equal(a, b) for a, b in zip(grads, again)):
            raise AssertionError(f'K6 {name}: two runs differ')
        f64 = [t.double() for t in (gates_x, w_hh)]
        h64, c64 = lstm.lstm_scan_reference(*f64)
        want = lstm.lstm_scan_bwd_plain(*f64, h64, c64, dh.double())
        torch.cuda.synchronize()
        fwd64 = min(fwd64, check_close(f'K5 {name} vs float64', ('h', 'c'),
                                       (h64, c64), (h, c))[0])
        worst, err = check_close(f'K6 {name}', ('dgates', 'dw_hh'), want,
                                 grads)
        bwd_worst, bwd_err = min(bwd_worst, worst), max(bwd_err, err)
        del gates_x, w_hh, dh, h, c, grads, again, f64, h64, c64, want
    torch.cuda.empty_cache()
    out['k5_err'], out['k6_err'] = fwd_err, bwd_err
    phase(22, f'{len(SCAN_CASES)} gates-in scan cases (DCCRN\'s two layers '
          f'at 16 x 4 s and at B=1, TF-GridNet\'s 0.05 s intra scan, H '
          f'32..256 at T=1, unaligned gates_x and w_hh): K5 h and c vs the '
          f'plain version worst {fwd_worst:.1f} dB, max abs err '
          f'{fwd_err:.3e}, vs float64 worst {fwd64:.1f} dB; K6 dgates and '
          f'dW_hh vs the plain backward in '
          f'float64 worst {bwd_worst:.1f} dB (>= {MIN_SNR_DB}), max abs err '
          f'{bwd_err:.3e} (each <= {MAX_REL_ERR} x max|ref|); two K5 and two '
          'K6 runs bitwise equal')

    # ---- phase 23: enhance from EnhanceService(model_dir) vs the plain
    # path in float64 on the card and in float32 on the CPU; the running
    # statistics moved off their initial values by train-mode passes
    model = ModelRegistry.get('dccrn')(device='cpu')
    model.init_parameters(23)
    model.to(device)
    rng = np.random.RandomState(23)
    with torch.no_grad():
        model.train()
        for _ in range(3):
            data = torch.from_numpy((0.1 * rng.randn(4, 2, 2, 2 * FS))
                                    .astype(np.float32)).to(device)
            model.loss(data, torch.full((4,), 2 * FS, device=device))
    state = {k: v.cpu() for k, v in model.state_dict().items()}
    params, aux = model.to_flax(state), model.flax_aux(state)
    del model
    with tempfile.TemporaryDirectory() as tmp:
        model_dir = write_model_dir(os.path.join(tmp, 'model'), 'dccrn',
                                    params=params, aux=aux)
        gpu = EnhanceService(model_dir, device)
        cpu = EnhanceService(model_dir, 'cpu')
    if count_params(gpu.model) != DCCRN_PARAMS:
        raise AssertionError(f'{count_params(gpu.model)} parameters')
    mix = (0.1 * np.random.RandomState(24).randn(4, 2, 4 * FS)) \
        .astype(np.float32)
    lstm.lstm_scan_x.launches = k5.launches = 0
    enhanced = gpu.model.enhance(mix)
    torch.cuda.synchronize()
    launches = (k5.launches, lstm.lstm_scan_x.launches)
    with plain_lstms():
        ref = dccrn_model(state, device, torch.float64).enhance(mix)
    snr, err = check_output('DCCRN enhance (4, 2, 64000)',
                            ref.cpu().numpy(), enhanced.cpu().numpy())
    cpu_snr, cpu_err = check_output('DCCRN enhance (4, 2, 64000) vs CPU',
                                     cpu.model.enhance(mix).numpy(),
                                     enhanced.cpu().numpy())
    if launches != (2, 0):
        raise AssertionError('DCCRN enhance: K5 {} and K3 {} launches'
                             .format(*launches))
    out['launches_serve'] = launches[0]
    del cpu
    phase(23, f'DCCRN ({DCCRN_PARAMS:,} parameters) from '
          f'EnhanceService(model_dir): enhance (4, 2, 64000) SNR {snr:.2f} dB'
          f', max abs err {err:.3e} vs the plain path in float64; '
          f'{cpu_snr:.2f} dB, {cpu_err:.3e} vs the plain CPU service; '
          f'{launches[0]} K5 launches (the complex LSTM\'s 2 layers, 2B = 8 '
          'rows), no K3')

    # ---- phase 24: gradients (2 x 2 s) and the running-statistics update
    # vs the plain path in float64
    rng = np.random.RandomState(25)
    target = 0.1 * rng.randn(2, 1, 2, 2 * FS)
    batch = torch.from_numpy(np.concatenate(
        [target + 0.1 * rng.randn(2, 1, 2, 2 * FS), target], axis=1)
        .astype(np.float32)).to(device)
    lengths = torch.tensor([2 * FS, 3 * FS // 2], device=device)
    with plain_lstms():
        ref, ref_stats = dccrn_grads(dccrn_model(state, device,
                                                 torch.float64),
                                     batch, lengths)
        plain, _ = dccrn_grads(dccrn_model(state, device), batch, lengths)
    k5.launches = k6.launches = 0
    got, got_stats = dccrn_grads(dccrn_model(state, device), batch, lengths)
    launches_grad = (k5.launches, k6.launches)
    if launches_grad != (2, 2):
        raise AssertionError('DCCRN gradients: K5 {} and K6 {} launches'
                             .format(*launches_grad))
    k_whole, k_worst, k_name, k_dead = grad_report(ref, got)
    p_whole, p_worst, p_name, p_dead = grad_report(ref, plain)
    # per tensor: 20 dB under the plain float32 path's worst tensor (at
    # most 60); a convolution bias that feeds a train-mode batch norm has a
    # zero gradient (the norm subtracts the batch mean), held within 10 x
    # the plain float32 path's rounding of it (at least 1e-5 of the
    # largest gradient)
    tensor_db = min(MIN_SNR_DB, p_worst - 20)
    dead_bound = max(1e-5, 10 * p_dead)
    if k_whole < MIN_SNR_DB or k_worst < tensor_db or k_dead > dead_bound:
        raise AssertionError(f'DCCRN gradients: whole {k_whole:.2f} dB, '
                             f'worst {k_name} {k_worst:.2f} dB (>= '
                             f'{tensor_db:.1f}), zero tensors {k_dead:.1e} '
                             f'(<= {dead_bound:.1e})')
    stats_db, stats_err = check_close(
        'DCCRN running statistics', list(ref_stats), ref_stats.values(),
        [got_stats[k] for k in ref_stats])
    n_stats = len(ref_stats)
    del ref, plain, got, ref_stats, got_stats
    torch.cuda.empty_cache()
    phase(24, f'DCCRN gradients (2 x 2 s, snr, train mode) vs the plain path'
          f' in float64: whole {k_whole:.1f} dB (>= {MIN_SNR_DB}), worst '
          f'tensor {k_worst:.1f} dB ({k_name}; >= {tensor_db:.1f}), '
          f'zero-gradient tensors within {k_dead:.1e} of the largest (<= '
          f'{dead_bound:.1e}); the plain float32 path: whole {p_whole:.1f} '
          f'dB, worst {p_worst:.1f} dB ({p_name}), zero {p_dead:.1e}; the '
          f'{n_stats} running statistics after the loss '
          f'{stats_db:.1f} dB, max abs err {stats_err:.3e}; '
          f'{launches_grad[0]} K5 and {launches_grad[1]} K6 launches')

    # ---- phase 25: training through train.main on the card
    epochs = 12
    with tempfile.TemporaryDirectory() as tmp:
        model_dir = tone_model_dir(tmp, 'dccrn', 40)
        first, second, train_s, (out['launches_train'],
                                 out['launches_train_bwd']) = \
            train_and_resume(lambda n: train_args(model_dir, n, 4), epochs,
                             [(k5, 'launches'), (k6, 'launches')])
        if not out['launches_train'] or not out['launches_train_bwd']:
            raise AssertionError('training launched K5 {} and K6 {} times'
                                 .format(out['launches_train'],
                                         out['launches_train_bwd']))
        losses = first.loss_logger.train_loss
        last = float(np.mean(losses[-3:]))
        if not np.isfinite(losses).all() \
                or losses[0] - last <= DCCRN_LOSS_DROP:
            raise AssertionError(f'training loss {losses[0]:.3f} -> '
                                 f'{last:.3f} dB')
        state_ckpt = load_checkpoint(second.last_ckpt_path)
        stats = state_ckpt['aux']['batch_stats']
        if not np.array_equal(stats['enc_norm_0']['var'],
                              second.model.enc_norm_0.var.cpu().numpy()):
            raise AssertionError('last.ckpt lacks the running statistics')
        served = build_model('dccrn', {}, state_ckpt['params'], device,
                             state_ckpt['aux'])
        item = second.val_dataset[0][0][None]
        torch.testing.assert_close(served.enhance(item),
                                   second.model.enhance(item), atol=1e-6,
                                   rtol=1e-5)
        metrics = [m for m in first.loss_logger.metrics if m][-1]
        phase(25, f'DCCRN train.main, 24 x 1 s tone-in-noise WAV items, '
              f'batch 8, {epochs} epochs in {train_s:.1f} s: train loss '
              f'{losses[0]:.3f} -> {last:.3f} dB (snr; a drop > '
              f'{DCCRN_LOSS_DROP}), val snr {metrics["snr"]:.2f} sisnr '
              f'{metrics["sisnr"]:.2f} dB; K5 {out["launches_train"]} / K6 '
              f'{out["launches_train_bwd"]} launches; resumed bitwise (the '
              f'running statistics from aux[\'batch_stats\']) from last.ckpt '
              f'to epoch {second.epochs_ran}; the checkpoint serves')

        # ---- phase 26: the HTTP service over the model directory
        service = EnhanceService(model_dir, device)
        ref_model = dccrn_model(service.model.state_dict(), device,
                                torch.float64)
        results = []
        k5.launches = 0
        with http_service(service) as (port, health):
            if health['params'] != DCCRN_PARAMS or health['arch'] != 'dccrn':
                raise AssertionError(f'/health: {health}')
            for seconds in (0.05, 4):
                audio = (0.1 * np.random.RandomState(26).randn(
                    int(seconds * FS))).astype(np.float32)
                before = k5.launches
                got = post_wav(port, audio)
                launched = k5.launches - before
                with plain_lstms():
                    want = ref_model.enhance(np.stack([audio, audio]))
                snr, _ = check_output(f'DCCRN /enhance {seconds} s',
                                      want.cpu().numpy(), got)
                if launched != 2:
                    raise AssertionError(f'/enhance {seconds} s: {launched} '
                                         'K5 launches, not 2')
                results.append(f'{seconds} s {snr:.1f} dB')
        out['launches_http'] = k5.launches
        phase(26, f'DCCRN /health ok, /enhance {", ".join(results)} from '
              f'EnhanceService(model_dir) on the trained last.ckpt (its '
              f'running statistics) vs the plain path in float64; '
              f'{out["launches_http"]} K5 launches')
        del first, second, served, service, ref_model

    # ---- phase 27: timings at 16 x 4 s (plain, kernel, kernel, plain)
    torch.cuda.empty_cache()
    timing = {}
    for label, case in (('layer0', DCCRN_LSTM[0]), ('layer1', DCCRN_LSTM[1])):
        steps, n_dir, rows, feat, hidden = case
        x, w_ih, bias, w_hh, dh = lstm_inputs(np.random.RandomState(27),
                                              *case)
        gates_x = (torch.einsum('tdre,dek->tdrk', x, w_ih)
                   + bias[None, :, None]).contiguous()
        with torch.no_grad():
            h, c = lstm.lstm_scan_fwd(gates_x, w_hh)
            fwd = in_turns({
                'kernel': lambda: lstm.lstm_scan_fwd(gates_x, w_hh),
                'plain': lambda: lstm.lstm_scan_reference(gates_x, w_hh)},
                5, 2)[0]
            bwd = in_turns({
                'kernel': lambda: lstm.lstm_scan_bwd(gates_x, w_hh, h, c, dh),
                'plain': lambda: lstm.lstm_scan_bwd_plain(gates_x, w_hh, h,
                                                          c, dh)}, 3, 1)[0]
            # the route the port takes below the row floor (the projection
            # in cuBLAS, then K5) against K3 with the projection inside
            fwd['route'] = cuda_ms(lambda: lstm.lstm_scan_fwd(
                (torch.einsum('tdre,dek->tdrk', x, w_ih)
                 + bias[None, :, None]).contiguous(), w_hh), 5, 2)
            fwd['k3'] = cuda_ms(
                lambda: lstm.lstm_scan_x_fwd(x, w_ih, bias, w_hh), 5, 2)
            hx, cx = lstm.lstm_scan_x_fwd(x, w_ih, bias, w_hh)
            bwd['k4'] = cuda_ms(lambda: lstm.lstm_scan_x_bwd(
                x, w_ih, bias, w_hh, hx, cx, dh), 3, 1)
        # the library's yardstick: cuDNN's LSTM over the same (T, R, E)
        # input, the input projection inside (no PyTorch call takes
        # precomputed gates): over both weight sets (a bidirectional LSTM,
        # the work of one K5/K6 launch over D = 2) and over one
        xl = x[:, 0].clone().requires_grad_()
        lib = {}
        for dirs in ('both', 'one'):
            cudnn = torch.nn.LSTM(feat, hidden, bidirectional=dirs == 'both'
                                  ).to(device)
            with torch.no_grad():
                lib[f'fwd_{dirs}'] = cuda_ms(lambda: cudnn(xl), 5, 2)
            out_l, _ = cudnn(xl)
            dout = torch.randn_like(out_l)
            lib[f'bwd_{dirs}'] = cuda_ms(lambda: torch.autograd.grad(
                out_l, [xl, *cudnn.parameters()], dout, retain_graph=True),
                3, 1)
            del cudnn, out_l, dout
        # bounds: the gate products h w_hh of every step (the backward
        # recomputes them, then dh w_hh^T and dW_hh); bytes of gates_x,
        # h, c (dh, dgates) and the weights
        flops = 2 * n_dir * steps * rows * hidden * 4 * hidden
        seq_g = steps * n_dir * rows * 4 * hidden
        seq_h = steps * n_dir * rows * hidden
        weights = n_dir * hidden * 4 * hidden
        timing[label] = {
            'fwd': fwd, 'bwd': bwd, 'lib_fwd': lib['fwd_both'],
            'lib_bwd': lib['bwd_both'], 'lib_fwd_one': lib['fwd_one'],
            'lib_bwd_one': lib['bwd_one'],
            'bound_fwd': bound(flops, 4 * (seq_g + weights + 2 * seq_h)),
            'bound_bwd': bound(3 * flops, 4 * (2 * seq_g + 2 * weights
                                               + 3 * seq_h))}
        del x, w_ih, bias, w_hh, dh, gates_x, h, c, hx, cx, xl
    batch = torch.from_numpy((0.1 * np.random.RandomState(28).randn(
        16, 2, 4 * FS)).astype(np.float32)).to(device)

    def plain_enhance():
        with plain_lstms():
            gpu.model.enhance(batch)

    k5.launches = 0
    gpu.model.enhance(batch)
    out['launches_eval'] = k5.launches
    enhance_ms, enhance_peak = in_turns(
        {'kernel': lambda: gpu.model.enhance(batch), 'plain': plain_enhance},
        3, 1)
    del gpu, batch
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        step_trainer, data, n = make_trainer(device, tmp, arch='dccrn')
        k6.launches = 0
        step_trainer.train_step(data, n)
        out['launches_bwd_step'] = k6.launches

        def kernel_step():
            step_trainer.train_step(data, n)

        def plain_step():
            with plain_lstms():
                step_trainer.train_step(data, n)

        step_ms, step_peak = in_turns({'kernel': kernel_step,
                                       'plain': plain_step}, 3, 1)
        del step_trainer, data
    if (out['launches_eval'], out['launches_bwd_step']) != (2, 2):
        raise AssertionError('DCCRN 16 x 4 s: {} K5 launches an evaluation,'
                             ' {} K6 a backward'.format(
                                 out['launches_eval'],
                                 out['launches_bwd_step']))
    out.update(timing=timing, enhance_ms=enhance_ms, step_ms=step_ms,
               enhance_peak=enhance_peak, step_peak=step_peak)
    mib = 2 ** 20
    t0, t1 = timing['layer0'], timing['layer1']
    cfwd, cbwd = (scan_cluster_record(timing, w) for w in ('fwd', 'bwd'))
    clusters = (f'N={cfwd["blocks"]} blocks of {cfwd["threads_per_block"]} '
                f'threads, K5 {cfwd["us_per_step"]:.2f} us a step and '
                f'{cfwd["smem_bytes"]} B a block, K6 '
                f'{cbwd["us_per_step"]:.2f} us a step and '
                f'{cbwd["smem_bytes"]} B')
    phase(27, f'[{card}] DCCRN complex LSTM at 16x4 s (T=495 D=2 R=32 '
          f'H=128) kernel/plain ms: K5 {t0["fwd"]["kernel"]:.3f}/'
          f'{t0["fwd"]["plain"]:.3f} ({1e3 * t0["fwd"]["kernel"] / 495:.2f} '
          f'us a step; bound {t0["bound_fwd"][0]:.3f}), K6 '
          f'{t0["bwd"]["kernel"]:.3f}/{t0["bwd"]["plain"]:.3f} (bound '
          f'{t0["bound_bwd"][0]:.3f}); cluster {clusters}; projection + K5 '
          f'vs K3 (projection '
          f'inside): E=512 {t0["fwd"]["route"]:.3f} vs {t0["fwd"]["k3"]:.3f}'
          f', E=128 {t1["fwd"]["route"]:.3f} vs {t1["fwd"]["k3"]:.3f}; K4 '
          f'E=512 {t0["bwd"]["k4"]:.3f}, E=128 {t1["bwd"]["k4"]:.3f}; cuDNN '
          f'LSTM fwd/bwd over both weight sets E=512 {t0["lib_fwd"]:.3f}/'
          f'{t0["lib_bwd"]:.3f}, E=128 {t1["lib_fwd"]:.3f}/'
          f'{t1["lib_bwd"]:.3f} (one: E=512 {t0["lib_fwd_one"]:.3f}/'
          f'{t0["lib_bwd_one"]:.3f}); enhance 16x4 s '
          f'{enhance_ms["kernel"]:.2f} ms, peak '
          f'{enhance_peak["kernel"] / mib:.1f} MiB (plain LSTMs '
          f'{enhance_ms["plain"]:.2f} ms); train step 16x4 s f32 '
          f'{step_ms["kernel"]:.2f} ms, peak {step_peak["kernel"] / mib:.1f} '
          f'MiB (plain LSTMs {step_ms["plain"]:.2f} ms, '
          f'{step_peak["plain"] / mib:.1f} MiB); {out["launches_eval"]} K5 '
          f'launches an evaluation, {out["launches_bwd_step"]} K6 a backward')
    return out


MANNER_PARAMS = 21_253_921
#: MANNER's BatchNorm shape classes at 16 x 4 s (padded length 64,084),
#: one of each route of the flash-BN plan: the full-resolution level
#: (in_bn, dec_0_up_bn; past a 16-block cluster), level 0's ResCon (an
#: 8-block cluster), level 1's (a 2-block cluster), a level-2 one (one
#: block), the widest (dec_3_rescon pw1_bn, C = 1920 at 249: one block,
#: 4-byte loads) and the local attention's C = 1 gate over 160 chunks of 64
BN_CASES = [(16, 60, 64084), (16, 120, 16020), (16, 240, 4004),
            (16, 960, 1000), (16, 1920, 249), (160, 1, 64)]
#: a short MANNER training run's train loss must end at most at this
#: fraction of its first epoch's (phase 31)
MANNER_LOSS_RATIO = 0.95
#: the least SNR against float64 of any live MANNER gradient tensor
#: (phase 30): a zero gradient reads 0 dB, a sign-flipped one -6 dB
TENSOR_FLOOR_DB = 6.0
#: the fused STFT's cases at 16 x 4 s: TF-GridNet's, and DCCRN's and
#: SGMSE+'s (n_fft, hop)
#: K9's cases at 16 x 4 s (phase 33), (n_fft, hop): the FFT route at
#: TF-GridNet's, DCCRN's and SGMSE+'s sizes and its largest, the dense
#: route at an n_fft that is no power of two
STFT_CASES = [(256, 128), (512, 128), (4096, 1024), (400, 100)]


@contextlib.contextmanager
def plain_batchnorms():
    """Every train-mode MANNER BatchNorm runs the plain forward and its
    memory-lean backward instead of K7-BN and K8-BN."""
    from brever_tpu_torch.models import common
    from brever_tpu_torch.ops import batchnorm
    common.batch_norm_act = batchnorm.batch_norm_act_plain
    try:
        yield
    finally:
        common.batch_norm_act = batchnorm.batch_norm_act


def bn_library(x, scale, bias, act):
    """``F.batch_norm(training=True)`` + the activation: the library
    yardstick, never called by the port."""
    import torch.nn.functional as F
    y = F.batch_norm(x, None, None, scale, bias, True, 0.0, 1e-5)
    if act == 'relu':
        return F.relu(y)
    return F.silu(y) if act == 'silu' else y


def bn_bounds(shape):
    """(K7-BN, K8-BN) bounds: x read and y written; x and dy read and dx
    written (the (C,) vectors are a few KB; a few flops an element is far
    below the bytes)."""
    n = int(np.prod(shape))
    return bound(10 * n, 4 * 2 * n), bound(20 * n, 4 * 3 * n)


def manner_model(state, device, dtype=torch.float32):
    """The default ``manner`` on ``device`` in ``dtype`` holding a state_dict
    (running statistics included), in eval mode."""
    from brever_tpu_torch.models import ModelRegistry
    model = ModelRegistry.get('manner')(device='cpu')
    model.load_state_dict(state)
    return model.to(device=device, dtype=dtype).eval()


def manner_grads(model, batch, lengths):
    """Gradients of the train-mode loss, and the running statistics that
    loss left (a float64 model gets a float64 batch)."""
    from brever_tpu_torch.models.base import sample_weighted_mean
    model.train()
    dtype = model.net.in_conv.weight.dtype
    loss = sample_weighted_mean(model.loss(batch.to(dtype), lengths),
                                lengths)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    model.eval()
    return ({k: g.double().cpu().numpy()
             for (k, _), g in zip(model.named_parameters(), grads)},
            {k: b.detach().clone() for k, b in model.named_buffers()})


def onecycle_f64(count, total, peak=1e-3):
    """optax's cosine one-cycle value in float64, for the schedule check."""
    bounds = (0, int(0.3 * total), total)
    values = (peak / 25, peak, peak / 25 / 1e4)
    for i in range(2):
        if bounds[i] <= count < bounds[i + 1]:
            pct = (count - bounds[i]) / (bounds[i + 1] - bounds[i])
            return values[i + 1] + (values[i] - values[i + 1]) / 2 \
                * (np.cos(np.pi * pct) + 1)
    return values[2]


def manner_phases(device, card):
    """Phases 28-32 (MANNER and flash-BN); returns the numbers of the
    K7-BN/K8-BN JSON records."""
    from brever_tpu_torch.checkpoint import load_checkpoint
    from brever_tpu_torch.models import ModelRegistry, common, count_params
    from brever_tpu_torch.models import manner
    from brever_tpu_torch.bench_alu_dtype import time_calls
    from brever_tpu_torch.bench_batchnorm import (launches_a_call,
                                                  time_bwd_routes)
    from brever_tpu_torch.ops import batchnorm as bn
    from brever_tpu_torch.profile_train import make_trainer
    from brever_tpu_torch.serve import EnhanceService, build_model
    out = {}
    torch.cuda.empty_cache()
    kf, kb = bn.batch_norm_act_fwd, bn.batch_norm_act_bwd

    # ---- phase 28: K7-BN and K8-BN vs their plain versions on the card
    rng = np.random.RandomState(28)
    fwd_worst, fwd_err, bwd_worst, bwd_err, n_cases = (float('inf'), 0.0,
                                                       float('inf'), 0.0, 0)
    routes = []
    for shape in BN_CASES:
        plan = bn.plan_info(*shape)
        routes.append(f'{shape} {plan["route_fwd"]}/{plan["route_bwd"]}'
                      f'/{plan["cluster"]}')
        for act in ('none', 'relu', 'silu'):
            name = f'{shape} {act}'
            x, scale, bias, dy = gn_inputs(rng, shape, device)
            y, mean, var, rstd = kf(x, scale, bias, 1e-5, act)
            if not all(torch.equal(a, b) for a, b in zip(
                    (y, mean, var, rstd), kf(x, scale, bias, 1e-5, act))):
                raise AssertionError(f'K7-BN {name}: two runs differ')
            ref = bn.batch_norm_act_reference(x, scale, bias, 1e-5, act)
            worst, err = check_close(f'K7-BN {name}',
                                     ('y', 'mean', 'var', 'rstd'), ref,
                                     (y, mean, var, rstd))
            fwd_worst, fwd_err = min(fwd_worst, worst), max(fwd_err, err)
            del ref
            grads = kb(x, dy, scale, bias, mean, rstd, act)
            again = kb(x, dy, scale, bias, mean, rstd, act)
            if not all(torch.equal(a, b) for a, b in zip(grads, again)):
                raise AssertionError(f'K8-BN {name}: two runs differ')
            del again
            # ReLU's branch at a z within rounding of 0 is the kernel's
            dy64, act64 = ((dy * (y > 0)).double(), 'none') \
                if act == 'relu' else (dy.double(), act)
            want = bn.batch_norm_act_bwd_plain(
                x.double(), dy64, scale.double(), bias.double(),
                mean.double(), rstd.double(), act64)
            worst, err = check_close(f'K8-BN {name}',
                                     ('dx', 'dscale', 'dbias'), want, grads)
            bwd_worst, bwd_err = min(bwd_worst, worst), max(bwd_err, err)
            n_cases += 1
            del x, y, dy, dy64, grads, want
    torch.cuda.empty_cache()
    out['fwd_err'], out['bwd_err'] = fwd_err, bwd_err
    phase(28, f'{n_cases} BatchNorm cases (MANNER\'s shape classes at '
          f'16 x 4 s, route K7-BN/K8-BN/cluster: {"; ".join(routes)}; '
          f'none, ReLU, SiLU): K7-BN y, mean, var, rstd vs the plain version '
          f'worst {fwd_worst:.1f} dB, max abs err {fwd_err:.3e}; K8-BN dx, '
          f'dscale, dbias vs the plain backward in float64 worst '
          f'{bwd_worst:.1f} dB (>= {MIN_SNR_DB}), max abs err '
          f'{bwd_err:.3e} (each <= {MAX_REL_ERR} x max|ref|); two runs of '
          'each bitwise equal')

    # ---- phase 29: serving: enhance from EnhanceService(model_dir) and
    # HTTP, the running statistics moved off their initial values by
    # train-mode passes; eval mode launches no kernel
    model = ModelRegistry.get('manner')(device='cpu')
    model.init_parameters(29)
    model.to(device).train()
    rng = np.random.RandomState(29)
    with torch.no_grad():
        for _ in range(2):
            data = torch.from_numpy((0.1 * rng.randn(4, 2, 2, 2 * FS))
                                    .astype(np.float32)).to(device)
            model.loss(data, torch.full((4,), 2 * FS, device=device))
    state = {k: v.cpu() for k, v in model.state_dict().items()}
    params, aux = model.to_flax(state), model.flax_aux(state)
    del model, data
    with tempfile.TemporaryDirectory() as tmp:
        model_dir = write_model_dir(os.path.join(tmp, 'model'), 'manner',
                                    params=params, aux=aux)
        gpu = EnhanceService(model_dir, device)
    n_bn = manner.count_batch_norms(gpu.model)
    if count_params(gpu.model) != MANNER_PARAMS \
            or n_bn != manner.N_BATCH_NORMS:
        raise AssertionError(f'{count_params(gpu.model)} parameters, '
                             f'{n_bn} BatchNorms')
    ref_model = manner_model(state, device, torch.float64)
    mix = (0.1 * np.random.RandomState(30).randn(4, 2, 4 * FS)) \
        .astype(np.float32)
    kf.launches = 0
    enhanced = gpu.model.enhance(mix)
    torch.cuda.synchronize()
    eval_launches = kf.launches
    snr, err = check_output('MANNER enhance (4, 2, 64000)',
                            ref_model.enhance(mix).cpu().numpy(),
                            enhanced.cpu().numpy())
    results = []
    with http_service(gpu) as (port, health):
        if health['params'] != MANNER_PARAMS or health['arch'] != 'manner':
            raise AssertionError(f'/health: {health}')
        for seconds in (0.05, 4):
            audio = (0.1 * np.random.RandomState(31).randn(
                int(seconds * FS))).astype(np.float32)
            got = post_wav(port, audio)
            want = ref_model.enhance(np.stack([audio, audio]))
            h_snr, _ = check_output(f'MANNER /enhance {seconds} s',
                                    want.cpu().numpy(), got)
            results.append(f'{seconds} s {h_snr:.1f} dB')
    out['launches_serve'] = kf.launches
    if out['launches_serve']:
        raise AssertionError(f'eval launched K7-BN {kf.launches} times')
    del ref_model
    phase(29, f'MANNER ({MANNER_PARAMS:,} parameters, {n_bn} BatchNorms) '
          f'from EnhanceService(model_dir): enhance (4, 2, 64000) SNR '
          f'{snr:.2f} dB, max abs err {err:.3e} vs the plain path in '
          f'float64; /health ok, /enhance {", ".join(results)}; '
          f'{eval_launches} K7-BN launches in eval mode (running statistics)')

    # ---- phase 30: gradients (2 x 2 s) and the running-statistics update
    # vs the plain path in float64
    rng = np.random.RandomState(32)
    target = 0.1 * rng.randn(2, 1, 2, 2 * FS)
    batch = torch.from_numpy(np.concatenate(
        [target + 0.1 * rng.randn(2, 1, 2, 2 * FS), target], axis=1)
        .astype(np.float32)).to(device)
    lengths = torch.tensor([2 * FS, 3 * FS // 2], device=device)
    with plain_batchnorms():
        ref, ref_stats = manner_grads(manner_model(state, device,
                                                   torch.float64),
                                      batch, lengths)
        plain, _ = manner_grads(manner_model(state, device), batch, lengths)
    kf.launches = kb.launches = 0
    got, got_stats = manner_grads(manner_model(state, device), batch,
                                  lengths)
    launches_grad = (kf.launches, kb.launches)
    if launches_grad != (n_bn, n_bn):
        raise AssertionError('MANNER gradients: K7-BN {} and K8-BN {} '
                             'launches'.format(*launches_grad))
    k_whole, k_worst, k_name, k_dead = grad_report(ref, got)
    p_whole, p_worst, p_name, p_dead = grad_report(ref, plain)
    # the whole gradient and each live tensor within 10 dB of the plain
    # float32 path's SNR on it (at 60 dB where that path is higher), and
    # each tensor at 6 dB at least, which a zero or sign-flipped gradient
    # (0 and -6 dB) fails: float32 through 69 stacked train-mode
    # BatchNorms keeps about 45 dB whole, and a BatchNorm's scale gradient
    # over a cancelling sum less (the C = 1 gates'); a conv bias that
    # feeds a train-mode BatchNorm has a zero gradient, held within 10 x
    # the plain float32 path's rounding
    top = max(float(np.abs(v).max()) for v in ref.values())
    live = [k for k in ref if np.abs(ref[k]).max() > 1e-6 * top]
    margin = {k: snr_db(ref[k], got[k]) - snr_db(ref[k], plain[k])
              for k in live}
    short = [k for k in live if snr_db(ref[k], got[k]) < max(
        TENSOR_FLOOR_DB, min(MIN_SNR_DB, snr_db(ref[k], plain[k]) - 10))]
    k_margin = min(margin, key=margin.get)
    whole_db = min(MIN_SNR_DB, p_whole - 10)
    dead_bound = max(1e-5, 10 * p_dead)
    if k_whole < whole_db or short or k_dead > dead_bound:
        raise AssertionError(f'MANNER gradients: whole {k_whole:.2f} dB (>= '
                             f'{whole_db:.1f}), tensors under their floor '
                             f'{short}, zero tensors '
                             f'{k_dead:.1e} (<= {dead_bound:.1e})')
    stats_db, stats_err = check_close(
        'MANNER running statistics', list(ref_stats), ref_stats.values(),
        [got_stats[k] for k in ref_stats])
    out['grad'] = dict(whole=k_whole, worst=k_worst, plain_whole=p_whole)
    del ref, plain, got, ref_stats, got_stats, batch
    torch.cuda.empty_cache()
    phase(30, f'MANNER gradients (2 x 2 s, train mode) vs the plain-BN path '
          f'in float64: whole {k_whole:.1f} dB (>= {whole_db:.1f}), worst '
          f'tensor {k_worst:.1f} dB ({k_name}), each within 10 dB of the '
          f'plain float32 path\'s SNR on it and >= {TENSOR_FLOOR_DB} dB '
          f'(least margin {margin[k_margin]:+.1f} dB, {k_margin}), '
          f'zero-gradient tensors within '
          f'{k_dead:.1e} of the largest (<= {dead_bound:.1e}); the plain '
          f'float32 path: whole {p_whole:.1f} dB, worst {p_worst:.1f} dB '
          f'({p_name}), zero {p_dead:.1e}; the '
          f'running statistics after the loss {stats_db:.1f} dB, max abs err '
          f'{stats_err:.3e}; {launches_grad[0]} K7-BN and {launches_grad[1]} '
          'K8-BN launches')

    # ---- phase 31: training through train.main on the card
    epochs = 6
    with tempfile.TemporaryDirectory() as tmp:
        model_dir = tone_model_dir(tmp, 'manner', 50)
        first, second, train_s, (out['launches_train'],
                                 out['launches_train_bwd']) = \
            train_and_resume(lambda n: train_args(model_dir, n, 3), epochs,
                             [(kf, 'launches'), (kb, 'launches')])
        if not out['launches_train'] or not out['launches_train_bwd']:
            raise AssertionError('training launched K7-BN {} and K8-BN {} '
                                 'times'.format(out['launches_train'],
                                                out['launches_train_bwd']))
        losses = first.loss_logger.train_loss
        last = float(np.mean(losses[-2:]))
        if not np.isfinite(losses).all() \
                or last > MANNER_LOSS_RATIO * losses[0]:
            raise AssertionError(f'training loss {losses[0]:.4f} -> '
                                 f'{last:.4f}')
        # the one-cycle schedule over the run's updates, as optax's
        total = len(first.train_batch_sampler) * epochs
        opt = first.optimizer
        rates = [opt.learning_rate(i) for i in range(total + 1)]
        want = [onecycle_f64(i, total) for i in range(total + 1)]
        if not opt.schedule_count == first.step == total \
                or not np.allclose(rates, want, rtol=1e-5, atol=0) \
                or not max(rates) == rates[int(0.3 * total)]:
            raise AssertionError(f'schedule count {opt.schedule_count}, '
                                 f'step {first.step}, rates {rates}')
        state_ckpt = load_checkpoint(second.last_ckpt_path)
        stats = state_ckpt['aux']['batch_stats']
        if not np.array_equal(stats['in_bn']['var'],
                              second.model.net.in_bn.var.cpu().numpy()):
            raise AssertionError('last.ckpt lacks the running statistics')
        served = build_model('manner', {}, state_ckpt['params'], device,
                             state_ckpt['aux'])
        item = second.val_dataset[0][0][None]
        torch.testing.assert_close(served.enhance(item),
                                   second.model.enhance(item), atol=1e-6,
                                   rtol=1e-5)
        val = [v for v in first.loss_logger.val_loss if v is not None]
        phase(31, f'MANNER train.main, 24 x 1 s tone-in-noise WAV items, '
              f'batch 8, {epochs} epochs in {train_s:.1f} s: train loss '
              f'{losses[0]:.4f} -> {last:.4f} (<= {MANNER_LOSS_RATIO} x), '
              f'val loss {val[0]:.4f} -> {val[-1]:.4f}; one-cycle rate '
              f'{rates[0]:.3g} -> {max(rates):.3g} at update '
              f'{int(0.3 * total)} -> {rates[total]:.3g} at {total}, as '
              f'optax\'s schedule; K7-BN {out["launches_train"]} / K8-BN '
              f'{out["launches_train_bwd"]} launches; resumed bitwise (the '
              f'running statistics, Adam and the schedule\'s count) from '
              f'last.ckpt to epoch {second.epochs_ran}; the checkpoint serves')
        del first, second, served

    # ---- phase 32: timings at 16 x 4 s (plain, kernel, kernel, plain)
    torch.cuda.empty_cache()
    rng = np.random.RandomState(33)
    x, scale, bias, dy = gn_inputs(rng, BN_CASES[0], device)
    with torch.no_grad():
        _, mean, _, rstd = kf(x, scale, bias, 1e-5, 'relu')
        calls = {'fwd': lambda: kf(x, scale, bias, 1e-5, 'relu'),
                 'bwd': lambda: kb(x, dy, scale, bias, mean, rstd, 'relu')}
        fwd = in_turns({
            'kernel': calls['fwd'],
            'plain': lambda: bn.batch_norm_act_reference(x, scale, bias,
                                                         1e-5, 'relu')},
            10, 2)[0]
        bwd = in_turns({
            'kernel': calls['bwd'],
            'plain': lambda: bn.batch_norm_act_bwd_plain(
                x, dy, scale, bias, mean, rstd, 'relu')}, 10, 2)[0]
        fwd['library'] = cuda_ms(lambda: bn_library(x, scale, bias, 'relu'),
                                 10, 2)
        # the card's time (calls queued behind a sleep kernel) and the
        # host's a call
        for key, times in (('fwd', fwd), ('bwd', bwd)):
            times['card'], times['host'] = time_calls(calls[key], device, 20)
    leaves = [t.clone().requires_grad_() for t in (x, scale, bias)]
    y_lib = bn_library(*leaves, 'relu')
    bwd['library'] = cuda_ms(lambda: torch.autograd.grad(
        y_lib, leaves, dy, retain_graph=True), 10, 2)
    del x, dy, mean, rstd, leaves, y_lib, calls
    out['largest'] = {'fwd': fwd, 'bwd': bwd,
                      'bound': bn_bounds(BN_CASES[0])}
    # K8-BN at the largest shape on the cluster that holds part of a
    # channel and on the passes, and the kernels a call launches on each
    # route (a trace in a fresh interpreter)
    out['candidates'] = time_bwd_routes(BN_CASES[0], 'relu', device)
    out['launches_a_call'] = launches_a_call()
    torch.cuda.empty_cache()
    batch = torch.from_numpy((0.1 * rng.randn(16, 2, 4 * FS))
                             .astype(np.float32)).to(device)
    enhance_ms = cuda_ms(lambda: gpu.model.enhance(batch), 3, 1)
    del gpu, batch
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        step_trainer, data, n = make_trainer(device, tmp, arch='manner')
        kf.launches = kb.launches = 0
        step_trainer.train_step(data, n)
        out['launches_step'] = (kf.launches, kb.launches)
        # every BatchNorm call of a step: its shape and activation
        calls = {}
        kernel_bn = common.batch_norm_act

        def record(x, scale, bias, eps=1e-5, act='none'):
            key = (tuple(x.shape), act)
            calls[key] = calls.get(key, 0) + 1
            return kernel_bn(x, scale, bias, eps, act)

        common.batch_norm_act = record
        try:
            step_trainer.train_step(data, n)
        finally:
            common.batch_norm_act = kernel_bn

        def kernel_step():
            step_trainer.train_step(data, n)

        def plain_step():
            with plain_batchnorms():
                step_trainer.train_step(data, n)

        step_ms, step_peak = in_turns({'kernel': kernel_step,
                                       'plain': plain_step}, 2, 1)
        del step_trainer, data
    torch.cuda.empty_cache()
    if out['launches_step'] != (n_bn, n_bn) or sum(calls.values()) != n_bn:
        raise AssertionError('MANNER 16 x 4 s step: K7-BN {}, K8-BN {} '
                             'launches, {} BatchNorm calls'.format(
                                 *out['launches_step'], sum(calls.values())))
    # the step's BatchNorms, each timed at its shape: kernel (as issued,
    # and on the card with the host's time a call), plain, library
    per_step = dict.fromkeys(('k7', 'k7_card', 'k7_host', 'plain', 'library',
                              'k8', 'k8_card', 'k8_host', 'plain_bwd',
                              'library_bwd', 'bound_k7', 'bound_k8'), 0.0)
    routes = {}
    for (shape, act), count in calls.items():
        x, scale, bias, dy = gn_inputs(rng, shape, device)
        plan = bn.plan_info(*shape)
        routes[str(shape)] = [plan['route_fwd'], plan['route_bwd'],
                              plan['cluster']]
        with torch.no_grad():
            _, mean, _, rstd = kf(x, scale, bias, 1e-5, act)
            times = {
                'k7': lambda: kf(x, scale, bias, 1e-5, act),
                'plain': lambda: bn.batch_norm_act_reference(
                    x, scale, bias, 1e-5, act),
                'library': lambda: bn_library(x, scale, bias, act),
                'k8': lambda: kb(x, dy, scale, bias, mean, rstd, act),
                'plain_bwd': lambda: bn.batch_norm_act_bwd_plain(
                    x, dy, scale, bias, mean, rstd, act)}
            for key, fn in times.items():
                per_step[key] += count * cuda_ms(fn, 3, 1)
            for key in ('k7', 'k8'):
                on_card, host = time_calls(times[key], device, 20)
                per_step[f'{key}_card'] += count * on_card
                per_step[f'{key}_host'] += count * host / n_bn
        leaves = [v.clone().requires_grad_() for v in (x, scale, bias)]
        y_lib = bn_library(*leaves, act)
        per_step['library_bwd'] += count * cuda_ms(
            lambda: torch.autograd.grad(y_lib, leaves, dy,
                                        retain_graph=True), 3, 1)
        b7, b8 = bn_bounds(shape)
        per_step['bound_k7'] += count * b7[0]
        per_step['bound_k8'] += count * b8[0]
        del x, dy, mean, rstd, leaves, y_lib
    torch.cuda.empty_cache()
    out.update(step_ms=step_ms, step_peak=step_peak, enhance_ms=enhance_ms,
               per_step=per_step, n_bn=n_bn, routes=routes)
    mib = 2 ** 20
    b = out['largest']['bound']
    cand = ', '.join(f'{r} {t:.4f}' for r, t in out['candidates'].items())
    launched = out['launches_a_call']
    phase(32, f'[{card}] K7-BN/K8-BN at {BN_CASES[0]} ReLU kernel/plain/'
          f'F.batch_norm+act ms: fwd {fwd["kernel"]:.3f}/{fwd["plain"]:.3f}/'
          f'{fwd["library"]:.3f} (card {fwd["card"]:.4f}, host '
          f'{fwd["host"]:.4f} a call; bound {b[0][0]:.3f}), bwd '
          f'{bwd["kernel"]:.3f}/{bwd["plain"]:.3f}/{bwd["library"]:.3f} '
          f'(card {bwd["card"]:.4f}, host {bwd["host"]:.4f}; bound '
          f'{b[1][0]:.3f}); K8-BN there on the card by route: {cand}; '
          f'kernels a call by route (a trace in a fresh interpreter): K7-BN '
          f'{launched["fwd"]}, K8-BN {launched["bwd"]}; summed over the '
          f'{n_bn} BatchNorms of a 16 x 4 s step ({len(calls)} shapes), as '
          f'issued/plain/library: K7-BN '
          f'{per_step["k7"]:.2f}/{per_step["plain"]:.2f}/'
          f'{per_step["library"]:.2f} (card {per_step["k7_card"]:.2f}, host '
          f'{per_step["k7_host"]:.4f} a call; bound '
          f'{per_step["bound_k7"]:.2f}), '
          f'K8-BN {per_step["k8"]:.2f}/{per_step["plain_bwd"]:.2f}/'
          f'{per_step["library_bwd"]:.2f} (card {per_step["k8_card"]:.2f}, '
          f'host {per_step["k8_host"]:.4f}; bound '
          f'{per_step["bound_k8"]:.2f}); enhance 16 x 4 s '
          f'{enhance_ms:.2f} ms; train step 16 x 4 s f32 '
          f'{step_ms["kernel"]:.1f} ms, peak '
          f'{step_peak["kernel"] / mib:.1f} MiB (plain BatchNorms '
          f'{step_ms["plain"]:.1f} ms, {step_peak["plain"] / mib:.1f} MiB); '
          f'{out["launches_step"][0]} K7-BN and {out["launches_step"][1]} '
          'K8-BN launches a step')
    return out


def stft_phase(device, card):
    """Phase 33 (the fused STFT, K9, on both routes); returns the numbers
    of its JSON record."""
    import torch.nn.functional as F
    from brever_tpu_torch.bench_alu_dtype import time_calls
    from brever_tpu_torch.models import ModelRegistry
    from brever_tpu_torch.ops import stft_kernel
    from brever_tpu_torch.ops.stft import STFT
    torch.cuda.empty_cache()
    k9 = stft_kernel.stft_fused
    rng = np.random.RandomState(34)
    signal = torch.from_numpy((0.1 * rng.randn(16, 4 * FS))
                              .astype(np.float32)).to(device)
    out, worst, max_err = {}, float('inf'), 0.0
    for n_fft, hop in STFT_CASES:
        stft = STFT(frame_length=n_fft, hop_length=hop, normalized=False,
                    backend='pallas')
        x = F.pad(stft.pad(signal), (n_fft // 2, n_fft // 2)).contiguous()
        basis = torch.from_numpy(stft_kernel.stft_basis(
            n_fft, stft._np_window)).to(device)
        window = torch.from_numpy(stft._np_window).to(device)
        route = stft_kernel.fft_route(n_fft)
        with torch.no_grad():
            before = (k9.launches, k9.dense_launches)
            got = k9(x, basis, hop)
            ran = (k9.launches - before[0], k9.dense_launches - before[1])
            if ran != ((1, 0) if route == 'fft' else (0, 1)):
                raise AssertionError(f'K9 {n_fft}/{hop}: route {route}, '
                                     f'launches (fft, dense) {ran}')
            plain = stft_kernel.stft_basis_plain(x, basis, hop)
            lib = torch.stft(x, n_fft, hop, window=window, center=False,
                             return_complex=True)     # (rows, bins, frames)
            bins = n_fft // 2 + 1
            lib_ri = torch.cat([lib.real, lib.imag], dim=1).transpose(1, 2)
            torch.cuda.synchronize()
            w1, e1 = check_close(f'K9 {n_fft}/{hop} vs plain', ('spec',),
                                 (plain,), (got,))
            w2, e2 = check_close(f'K9 {n_fft}/{hop} vs torch.stft',
                                 ('spec',), (lib_ri,), (got,))
            worst, max_err = min(worst, w1, w2), max(max_err, e1, e2)
            calls = {
                'kernel': lambda: k9(x, basis, hop),
                'plain': lambda: stft_kernel.stft_basis_plain(x, basis, hop),
                'library': lambda: torch.stft(
                    x, n_fft, hop, window=window, center=False,
                    return_complex=True)}
            # the host issues a call in about as long as the card runs the
            # FFT route's kernel: CUDA events around calls queued behind a
            # sleep kernel give the card's time, the host's time to issue a
            # call beside it; then the calls one after another as a caller
            # makes them (CUDA events, the host's pace included)
            queued = {name: time_calls(fn, device, 20)
                      for name, fn in calls.items()}
            times = {name: ms for name, (ms, _) in queued.items()}
            times['host'] = {name: h for name, (_, h) in queued.items()}
            times['paced'], _ = in_turns(
                {k: calls[k] for k in ('plain', 'kernel')}, 10, 2)
            times['paced']['library'] = cuda_ms(calls['library'], 10, 2)
            # the module's forward end to end: padding, K9 and the complex
            # view, the basis cached after the first call
            times['module'] = cuda_ms(lambda: stft(signal), 10, 2)
        rows, n = x.shape
        frames = got.shape[1]
        # the function needs a real FFT a frame (2.5 n log2 n operations,
        # half a complex FFT's 5 n log2 n), not the dense product the dense
        # route does; the signal read once and the spectrum written once
        fft_flops = 2.5 * rows * frames * n_fft * math.log2(n_fft)
        nbytes = 4 * (rows * n + rows * frames * 2 * bins)
        times['bound'] = bound(fft_flops, nbytes)
        times['dense_bound'] = bound(
            2 * rows * frames * n_fft * 2 * bins,
            nbytes + 4 * n_fft * 2 * bins)
        times['route'] = route
        times['snr'] = min(w1, w2)
        out[f'{n_fft}/{hop}'] = times
        del x, basis, got, plain, lib, lib_ri
    out['module_ms'] = out['512/128']['module']
    # one DCCRN enhance with its STFT on K9 (512/128: the FFT route)
    # against the cuFFT route
    model = ModelRegistry.get('dccrn')(device='cpu')
    model.init_parameters(35)
    model.to(device).eval()
    mix = (0.1 * rng.randn(4, 2, 4 * FS)).astype(np.float32)
    want = model.enhance(mix)
    model.stft.backend = 'pallas'
    k9.launches = k9.dense_launches = 0
    got = model.enhance(mix)
    torch.cuda.synchronize()
    out['launches'], out['launches_dense'] = k9.launches, k9.dense_launches
    if (out['launches'], out['launches_dense']) != (1, 0):
        raise AssertionError(f'DCCRN enhance: {k9.launches} K9 FFT-route '
                             f'and {k9.dense_launches} dense-route launches')
    snr, err = check_output('DCCRN enhance on K9',
                            want.cpu().numpy(), got.cpu().numpy())
    out['err'] = max_err
    del model
    torch.cuda.empty_cache()

    def line(key):
        t, p = out[key], out[key]['paced']
        return (f'{key} {t["route"]} {t["kernel"]:.4f}/{t["plain"]:.4f}/'
                f'{t["library"]:.4f} (paced {p["kernel"]:.4f}/'
                f'{p["plain"]:.4f}/{p["library"]:.4f}, host '
                f'{t["host"]["kernel"]:.4f}; bound {t["bound"][0]:.4f} by '
                f'{t["bound"][1]}, {t["snr"]:.1f} dB)')

    phase(33, f'[{card}] K9 (fused STFT) at 16 x 4 s vs stft_basis_plain and '
          f'torch.stft (cuFFT), same window and centre: worst '
          f'{worst:.1f} dB, max abs err {max_err:.3e}; route kernel/plain/'
          f'torch.stft ms on the card (calls queued; paced: one after '
          f'another as issued; host: ms to issue a kernel call): '
          + '; '.join(line(f'{n}/{h}') for n, h in STFT_CASES)
          + f'; STFT(backend=\'pallas\') forward end to end at 512/128 '
          f'{out["module_ms"]:.3f} ms; DCCRN enhance (4, 2, 64000) with '
          f'STFT(backend=\'pallas\') vs the cuFFT route {snr:.1f} dB, max abs '
          f'err {err:.3e}, {out["launches"]} K9 FFT-route launch, '
          f'{out["launches_dense"]} dense')
    return out


def lstm_repair_phase(device, card):
    """Phase 34: the LSTM kernels on the shapes they refused before."""
    from brever_tpu_torch.models import rnn
    from brever_tpu_torch.ops import lstm_scan as lstm
    torch.cuda.empty_cache()
    rng = np.random.RandomState(36)
    notes = []
    # H = 200 (padded to 224) at TF-GridNet's intra shape, through autograd
    steps, n_dir, rows, feat, _ = LSTM_INTRA
    x, w_ih, bias, w_hh, dh = lstm_inputs(rng, steps, n_dir, rows, feat, 200,
                                        device)
    leaves = [t.clone().requires_grad_() for t in (x, w_ih, bias, w_hh)]
    before = (lstm.lstm_scan_x.launches, lstm.lstm_scan_x_bwd.launches)
    h = lstm.lstm_scan_x(*leaves)
    grads = torch.autograd.grad(h, leaves, dh)
    launches = (lstm.lstm_scan_x.launches - before[0],
                lstm.lstm_scan_x_bwd.launches - before[1])
    if launches != (1, 1):
        raise AssertionError(f'H=200: K3/K4 launches {launches}')
    f64 = [t.double() for t in (x, w_ih, bias, w_hh)]
    h64, c64 = lstm.lstm_scan_x_reference(*f64)
    want = lstm.lstm_scan_x_bwd_plain(*f64, h64, c64, dh.double())
    torch.cuda.synchronize()
    w_h, e_h = check_close('H=200 h', ('h',), (h64,), (h,))
    w_g, e_g = check_close('H=200 grads', LSTM_NAMES, want, grads)
    notes.append(f'H=200 on K3/K4 (as 224) at {LSTM_INTRA[:4]}: h '
                 f'{w_h:.1f} dB, gradients worst {w_g:.1f} dB vs the plain '
                 'path in float64')
    del x, w_ih, bias, w_hh, dh, leaves, h, grads, f64, h64, c64, want
    torch.cuda.empty_cache()
    # an (E, H) past the shared memory: the projection, then K5/K6
    case = (20, 2, 256, 1024, 256)
    x, w_ih, bias, w_hh, _ = lstm_inputs(rng, *case, device)
    if lstm.fused_x_fits(1024, 256):
        raise AssertionError('E=1024 H=256 fits the fused kernels')
    before = (lstm.lstm_scan_x.launches, lstm.lstm_scan.launches)
    with torch.no_grad():
        h = rnn._dispatch_scan_x(x, w_ih, bias, w_hh)
    launches = (lstm.lstm_scan_x.launches - before[0],
                lstm.lstm_scan.launches - before[1])
    if launches != (0, 1):
        raise AssertionError(f'E=1024 H=256: K3/K5 launches {launches}')
    ref = lstm.lstm_scan_x_reference(x, w_ih, bias, w_hh)[0]
    w_s, _ = check_close('E=1024 H=256', ('h',), (ref,), (h,))
    notes.append(f'T=20 R=256 E=1024 H=256 (K3/K4 would need '
                 f'{4 * 32 * (1024 + 6 * 256)} B of shared memory) on the '
                 f'projection + K5: {w_s:.1f} dB')
    del x, w_ih, bias, w_hh, h, ref
    torch.cuda.empty_cache()
    # K5/K6 on row tiles past H = 512 against the plain version in float64,
    # two runs bitwise
    for case in ROW_TILE_CASES:
        name = 'T={} D={} R={} E={} H={}'.format(*case)
        x, w_ih, bias, w_hh, dh = wide_lstm_inputs(rng, *case, device)
        gates_x = (torch.einsum('tdre,dek->tdrk', x, w_ih)
                   + bias[None, :, None]).contiguous()
        del x, w_ih, bias
        before = (lstm.lstm_scan.launches, lstm.lstm_scan_bwd.launches)
        runs = [(*lstm.lstm_scan_fwd(gates_x, w_hh),) for _ in range(2)]
        runs = [(h, c, *lstm.lstm_scan_bwd(gates_x, w_hh, h, c, dh))
                for h, c in runs]
        if (lstm.lstm_scan.launches - before[0],
                lstm.lstm_scan_bwd.launches - before[1]) != (2, 2):
            raise AssertionError(f'K5/K6 {name}: launches')
        if not all(torch.equal(a, b) for a, b in zip(*runs)):
            raise AssertionError(f'K5/K6 {name}: two runs differ')
        f64 = [t.double() for t in (gates_x, w_hh)]
        h64, c64 = lstm.lstm_scan_reference(*f64)
        want = (h64, c64, *lstm.lstm_scan_bwd_plain(*f64, h64, c64,
                                                    dh.double()))
        torch.cuda.synchronize()
        w_e, _ = check_close(f'K5/K6 {name}', ('h', 'c', 'dgates', 'dw_hh'),
                             want, runs[0], min_db=WIDE_SCAN_DB)
        rows = lstm.scan_tile_rows(case[4])[0]
        notes.append(f'K5/K6 at {name} ({rows}-row tiles): h, c, dgates, '
                     f'dW_hh worst {w_e:.1f} dB (>= {WIDE_SCAN_DB}) vs the '
                     'plain path in float64, two runs bitwise')
        del gates_x, w_hh, dh, runs, f64, h64, c64, want
        torch.cuda.empty_cache()
    # H past K5/K6's 8192: the gates-in scan raises before any launch
    case = WIDE_CASE
    x, w_ih, bias, w_hh, _ = wide_lstm_inputs(rng, *case, device)
    leaves = [t.clone().requires_grad_() for t in (x, w_ih, bias, w_hh)]
    before = (lstm.lstm_scan.launches, lstm.lstm_scan_bwd.launches)
    try:
        rnn._dispatch_scan_x(*leaves)
    except NotImplementedError as exc:
        if 'shared memory' not in str(exc):
            raise
    else:
        raise AssertionError(f'H={case[4]}: the gates-in scan ran past 8192')
    launched = (lstm.lstm_scan.launches - before[0],
                lstm.lstm_scan_bwd.launches - before[1])
    if launched != (0, 0):
        raise AssertionError(f'H={case[4]}: K5, K6 launches {launched}')
    notes.append('T={} D={} R={} E={} H={} (past K5/K6) raises '
                 'NotImplementedError before any K5/K6 launch'.format(*case))
    del x, w_ih, bias, w_hh, leaves
    torch.cuda.empty_cache()
    # rows past the int range: T D R 4H >= 2**31 in two chunks
    steps, n_dir, feat, hidden = 126, 2, 128, 128
    rows = lstm._INT_RANGE // (steps * n_dir * 4 * hidden) + 64
    chunks = lstm.row_chunks(steps, n_dir, rows, 4 * hidden)
    # the weights from numpy, the 2 GB x and dh drawn on the card (numpy
    # would take tens of seconds on the host)
    _, w_ih, bias, w_hh, _ = lstm_inputs(rng, 1, n_dir, 1, feat, hidden,
                                         device)
    gen = torch.Generator(device=device).manual_seed(37)
    x, dh = (torch.randn(steps, n_dir, rows, width, generator=gen,
                         device=device) for width in (feat, hidden))
    before = (lstm.lstm_scan_x.launches, lstm.lstm_scan_x_bwd.launches)
    h, c = lstm.lstm_scan_x_fwd(x, w_ih, bias, w_hh)
    grads = lstm.lstm_scan_x_bwd(x, w_ih, bias, w_hh, h, c, dh)
    launches = (lstm.lstm_scan_x.launches - before[0],
                lstm.lstm_scan_x_bwd.launches - before[1])
    if launches != (len(chunks), len(chunks)) or len(chunks) < 2:
        raise AssertionError(f'{rows} rows: {chunks}, launches {launches}')
    worst = float('inf')
    for lo, hi in ((0, 64), (chunks[0][1] - 32, chunks[0][1] + 32),
                   (rows - 64, rows)):
        part = [t[:, :, lo:hi].contiguous() for t in (x, dh)]
        ref_h, ref_c = lstm.lstm_scan_x_reference(part[0], w_ih, bias, w_hh)
        ref_dx = lstm.lstm_scan_x_bwd_plain(part[0], w_ih, bias, w_hh, ref_h,
                                            ref_c, part[1])[0]
        worst = min(worst, check_close(
            f'{rows} rows [{lo}, {hi})', ('h', 'c', 'dx'),
            (ref_h, ref_c, ref_dx),
            (h[:, :, lo:hi], c[:, :, lo:hi], grads[0][:, :, lo:hi]))[0])
    # the weight gradients are the chunks' launches summed in order
    parts = [lstm.lstm_scan_x_bwd(*(t[:, :, lo:hi].contiguous()
                                    for t in (x,)), w_ih, bias, w_hh,
                                  *(t[:, :, lo:hi].contiguous()
                                    for t in (h, c, dh)))
             for lo, hi in chunks]
    for i in (1, 2, 3):
        total = parts[0][i]
        for p in parts[1:]:
            total = total + p[i]
        if not torch.equal(total, grads[i]):
            raise AssertionError(f'{rows} rows: weight gradient {i} is not '
                                 'the chunks\' sum')
    notes.append(f'T=126 D=2 R={rows} E=H=128 (T D R 4H = '
                 f'{steps * n_dir * rows * 4 * hidden:,} >= 2**31) in '
                 f'{len(chunks)} row chunks on K3/K4: h, c, dx on three row '
                 f'slices (the chunk edge included) vs the plain path worst '
                 f'{worst:.1f} dB; the weight gradients the chunks\' sum '
                 'bitwise')
    del x, w_ih, bias, w_hh, dh, h, c, grads, parts
    torch.cuda.empty_cache()
    phase(34, 'LSTM kernels on the shapes they refused: ' + '; '.join(notes))


#: K5/K6 against float64 on the row tiles past H = 512 (phase 34): the
#: gates, c, dgates and dW_hh sum up to 4H = 32768 float32 products in
#: another order than the float64 path, ~120 dB in PR 9's run at H <= 1024
WIDE_SCAN_DB = 100.0
#: a scan past K5/K6's largest hidden size (phase 34), (T, D, R, E, H):
#: it raises before any launch
WIDE_CASE = (40, 1, 32, 64, 8224)
#: K5/K6 on row tiles past H = 512 (phase 34), (T, D, R, E, H): 8-row tiles
#: at H = 640 at DCCRN's rows and H = 1024 at R off the tile, 4-row tiles
#: at 1056 and 2048, 2-row at 4096 and 1-row at 8192 (w_hh of 1 GB)
ROW_TILE_CASES = [(40, 2, 32, 64, 640), (20, 2, 33, 64, 1024),
                  (6, 2, 5, 64, 1056), (6, 2, 5, 64, 2048),
                  (3, 1, 3, 16, 4096), (3, 1, 2, 16, 8192)]
#: K10 against its plain version (phase 35): float32 within 1e-5 of the
#: largest value (the kernel's fused multiply-add rounds once a step where
#: the plain chain rounds twice: 256 steps of float32 rounding stay far
#: below it), bfloat16 within 2**-6 of the largest value, 4 bfloat16 ulps
#: at its top binade (the same double rounding in 8 significant bits)
FMA_F32_REL, FMA_BF16_REL = 1e-5, 2.0 ** -6
#: the most of K10's bound that a time may show: past it the kernel did
#: less work than the chain asks (5 % for the clock and timer's spread)
FMA_MAX_BOUND_SHARE = 1.05
#: the gates-in scan at the hidden sizes past 256 (phase 36): (T, D, R, E,
#: H), DCCRN's scan shape at 16 x 4 s at H = 512 and 384, rows off the
#: 16-row tile with D = 1, and a short scan at B = 1
WIDE_SCAN_CASES = [(495, 2, 32, 256, 512), (495, 2, 32, 256, 384),
                   (7, 1, 17, 16, 512), (40, 2, 2, 64, 384)]
IDMSE_PARAMS = {'idmse': 16_613_378, 'idmselarge': 70_995_586}
#: K7 launches of one U-Net evaluation: every GroupNorm without the external
#: affine (norm_1 of each block, the attention norms, output_norm); each
#: adm block's norm_2 takes the external affine on the plain route
IDMSE_EVAL_LAUNCHES = {'idmse': 22, 'idmselarge': 56}


def fma_phase(device, card):
    """Phase 35: the elementwise-rate probe (K10); returns its record."""
    from brever_tpu_torch import bench_alu_dtype as probe
    from brever_tpu_torch.ops import build
    from brever_tpu_torch.ops import fma_chain as fc
    torch.cuda.empty_cache()
    sass = probe.sass_report(build.library_path())
    # the main path: the probe's own timing of each dtype
    fc.fma_chain.launches = 0
    rows = {r['dtype']: r for r in (probe.bench(d, device)
                                    for d in probe.DTYPES)}
    launches = fc.fma_chain.launches
    if launches < len(probe.DTYPES) * (1 + probe.REPS):
        raise AssertionError(f'the probe launched K10 {launches} times')
    rec = {'name': 'fma_chain', 'route': 'cuda',
           'source': 'brever_tpu_torch/csrc/fma_chain.cu',
           'replaces': 'benchmarks/bench_vpu_dtype.py:35',
           'launches': launches, 'library_ms': None,
           'library_note': 'no PyTorch call computes the chain',
           'shape': f'({probe.ROWS}, {probe.T}, {probe.H}), k={probe.K}, '
                    f'passes={probe.PASSES}'}
    notes, max_err = [], 0.0

    def held(dtype, kind, k, passes, rel=None):
        """K10 against the plain chain within ``fma_chain_limit`` at every
        element (and ``rel`` of the largest value); returns the largest
        error and the case's margin over a chain one step short."""
        x = probe.probe_input(dtype, device, kind=kind)
        got, want = fc.fma_chain(x, k, passes), \
            fc.fma_chain_reference(x, k, passes)
        limit, margin = fc.fma_chain_limit(x, k, passes)
        case = f'K10 {dtype} {kind} input k={k} passes={passes}'
        if got.shape != x.shape or got.dtype != dtype \
                or not torch.isfinite(got).all():
            raise AssertionError(f'{case}: {got.shape} {got.dtype}')
        err = (got.double() - want.double()).abs()
        if (err > limit).any():
            i = int((err - limit).argmax())
            raise AssertionError(f'{case}: error {err.flatten()[i]:.3e} > '
                                 f'limit {limit.flatten()[i]:.3e} at {i}')
        top = want.double().abs().max().item()
        if rel is not None and err.max().item() > rel * top:
            raise AssertionError(f'{case}: max err {err.max():.3e} > '
                                 f'{rel:.1e} x {top:.4f}')
        return err.max().item(), margin.max().item()

    for dtype in probe.DTYPES:
        key = str(dtype).replace('torch.', '')
        rel = FMA_F32_REL if dtype == torch.float32 else FMA_BF16_REL
        for kind in ('bench', 'wide'):
            err, _ = held(dtype, kind, probe.K, probe.PASSES, rel)
            max_err = max(max_err, err)
            notes.append(f'{key} {kind} input {err:.2e} (<= {rel:.1e} x '
                         f'max|ref| and the limit)')
        x = probe.probe_input(dtype, device)
        rec.update({f'plain_ms{"" if dtype == torch.float32 else "_bf16"}':
                    cuda_ms(lambda: fc.fma_chain_reference(x), 3, 1)})
        del x
    steps = []
    for kind, k, passes, dtypes in probe.STEP_CASES:
        for dtype in dtypes:
            err, margin = held(dtype, kind, k, passes)
            if margin <= 0:
                raise AssertionError(f'K10 {dtype} {kind} k={k} passes='
                                     f'{passes}: the case cannot tell '
                                     f'{passes * (k // 2)} steps from one '
                                     f'fewer')
            steps.append(f'{str(dtype)[6:]} {kind} {k}/{passes} {err:.1e}')
    notes.append('within the limit and one step apart at k/passes ' +
                 ', '.join(steps))
    for dtype in probe.DTYPES:
        key = str(dtype).replace('torch.', '')
        row, suffix = rows[key], '' if dtype == torch.float32 else '_bf16'
        if row['bound_ms'] / row['ms'] > FMA_MAX_BOUND_SHARE:
            raise AssertionError(f'K10 {key}: {row["ms"]:.4f} ms is under '
                                 f'its bound {row["bound_ms"]:.4f} ms')
        rec.update({f'ms{suffix}': row['ms'],
                    f'host_ms{suffix}': row['host_ms'],
                    f'bound_ms{suffix}': row['bound_ms'],
                    f'bound_by{suffix}': row['bound_by'],
                    f'tops{suffix}': row['tops']})
    rec['max_abs_err'] = max_err
    rec['bf16_f32_time_ratio'] = rec['ms_bf16'] / rec['ms']
    print('K10 SASS: ' + '; '.join(
        f'{k}: {v["instructions"]} instructions, {v["ffma"]} FFMA, '
        f'{v["hfma2_bf16"]} HFMA2.BF16, {v["f32_arithmetic"]} float32 '
        f'arithmetic, conversions {v["conversions"] or "none"}'
        for k, v in sass.items()), flush=True)
    phase(35, f'[{card}] K10 (the elementwise-rate probe) from '
          f'bench_alu_dtype.bench: {launches} launches; SASS float32 chains '
          f'FFMA, bfloat16 HFMA2.BF16 with no conversion; vs the plain '
          f'chain: {"; ".join(notes)}; float32 {rec["ms"]:.4f} ms '
          f'({rec["tops"]:.2f} Top/s, host issue {rec["host_ms"]:.4f} ms, '
          f'plain {rec["plain_ms"]:.3f}, bound {rec["bound_ms"]:.4f} by '
          f'{rec["bound_by"]}: {100 * rec["bound_ms"] / rec["ms"]:.1f} %), '
          f'bfloat16 {rec["ms_bf16"]:.4f} ms ({rec["tops_bf16"]:.2f} Top/s, '
          f'host issue {rec["host_ms_bf16"]:.4f} ms, plain '
          f'{rec["plain_ms_bf16"]:.3f}, bound {rec["bound_ms_bf16"]:.4f} by '
          f'{rec["bound_by_bf16"]}: '
          f'{100 * rec["bound_ms_bf16"] / rec["ms_bf16"]:.1f} %); '
          f'bf16:f32 time ratio {rec["bf16_f32_time_ratio"]:.3f}')
    return rec


def wide_scan_phase(device, card):
    """Phase 36: K5/K6 at H = 384 and 512 (16-row tiles); returns the
    H = 512 times for the K5/K6 records."""
    from brever_tpu_torch.models import rnn
    from brever_tpu_torch.ops import lstm_scan as lstm
    torch.cuda.empty_cache()
    rng = np.random.RandomState(38)
    bwd_worst, bwd_err, fwd_err = float('inf'), 0.0, 0.0
    for case in WIDE_SCAN_CASES:
        name = 'T={} D={} R={} E={} H={}'.format(*case)
        x, w_ih, bias, w_hh, dh = lstm_inputs(rng, *case, device)
        gates_x = (torch.einsum('tdre,dek->tdrk', x, w_ih)
                   + bias[None, :, None]).contiguous()
        del x, w_ih, bias
        before = (lstm.lstm_scan.launches, lstm.lstm_scan_bwd.launches)
        h, c = lstm.lstm_scan_fwd(gates_x, w_hh)
        grads = lstm.lstm_scan_bwd(gates_x, w_hh, h, c, dh)
        again = lstm.lstm_scan_bwd(gates_x, w_hh, h, c, dh)
        if (lstm.lstm_scan.launches - before[0],
                lstm.lstm_scan_bwd.launches - before[1]) != (1, 2):
            raise AssertionError(f'K5/K6 {name}: launches')
        ref = lstm.lstm_scan_reference(gates_x, w_hh)
        torch.cuda.synchronize()
        for got, want in zip((h, c), ref):
            torch.testing.assert_close(got, want, atol=KERNEL_ATOL,
                                       rtol=KERNEL_RTOL)
            fwd_err = max(fwd_err, (got - want).abs().max().item())
        if not all(torch.equal(a, b) for a, b in zip(grads, again)):
            raise AssertionError(f'K6 {name}: two runs differ')
        f64 = [t.double() for t in (gates_x, w_hh)]
        h64, c64 = lstm.lstm_scan_reference(*f64)
        want = lstm.lstm_scan_bwd_plain(*f64, h64, c64, dh.double())
        torch.cuda.synchronize()
        worst, err = check_close(f'K6 {name}', ('dgates', 'dw_hh'), want,
                                 grads)
        bwd_worst, bwd_err = min(bwd_worst, worst), max(bwd_err, err)
        del gates_x, w_hh, dh, h, c, grads, again, ref, f64, h64, c64, want
    torch.cuda.empty_cache()
    # a BLSTM of 128 rows at H = 384 is routed to the projection and K5
    x, w_ih, bias, w_hh, _ = lstm_inputs(rng, 10, 2, 128, 64, 384, device)
    before = (lstm.lstm_scan_x.launches, lstm.lstm_scan.launches)
    with torch.no_grad():
        h = rnn._dispatch_scan_x(x, w_ih, bias, w_hh)
    routed = (lstm.lstm_scan_x.launches - before[0],
              lstm.lstm_scan.launches - before[1])
    if routed != (0, 1):
        raise AssertionError(f'H=384 at 128 rows: K3/K5 launches {routed}')
    torch.testing.assert_close(
        h, lstm.lstm_scan_x_reference(x, w_ih, bias, w_hh)[0],
        atol=KERNEL_ATOL, rtol=KERNEL_RTOL)
    del x, w_ih, bias, w_hh, h
    # times at H = 512 on DCCRN's scan shape (plain, kernel in turns)
    steps, n_dir, rows, feat, hidden = WIDE_SCAN_CASES[0]
    x, w_ih, bias, w_hh, dh = lstm_inputs(rng, steps, n_dir, rows, feat,
                                          hidden, device)
    gates_x = (torch.einsum('tdre,dek->tdrk', x, w_ih)
               + bias[None, :, None]).contiguous()
    with torch.no_grad():
        h, c = lstm.lstm_scan_fwd(gates_x, w_hh)
        fwd = in_turns({
            'kernel': lambda: lstm.lstm_scan_fwd(gates_x, w_hh),
            'plain': lambda: lstm.lstm_scan_reference(gates_x, w_hh)},
            3, 1)[0]
        bwd = in_turns({
            'kernel': lambda: lstm.lstm_scan_bwd(gates_x, w_hh, h, c, dh),
            'plain': lambda: lstm.lstm_scan_bwd_plain(gates_x, w_hh, h, c,
                                                      dh)}, 3, 1)[0]
    flops = 2 * n_dir * steps * rows * hidden * 4 * hidden
    seq_g = steps * n_dir * rows * 4 * hidden
    seq_h = steps * n_dir * rows * hidden
    weights = n_dir * hidden * 4 * hidden
    out = {'fwd': fwd, 'bwd': bwd,
           'bound_fwd': bound(flops, 4 * (seq_g + weights + 2 * seq_h)),
           'bound_bwd': bound(3 * flops, 4 * (2 * seq_g + 2 * weights
                                              + 3 * seq_h))}
    del x, w_ih, bias, w_hh, dh, gates_x, h, c
    torch.cuda.empty_cache()
    phase(36, f'[{card}] {len(WIDE_SCAN_CASES)} gates-in scan cases at H = '
          f'384 and 512 (16-row tiles): K5 h and c vs the plain version max '
          f'abs err {fwd_err:.3e} (atol {KERNEL_ATOL}, rtol {KERNEL_RTOL}); '
          f'K6 vs the plain backward in float64 worst {bwd_worst:.1f} dB '
          f'(>= {MIN_SNR_DB}), max abs err {bwd_err:.3e} (<= {MAX_REL_ERR} x '
          f'max|ref|), two runs bitwise equal; a 128-row BLSTM at H=384 '
          f'routed to the projection + K5; T={steps} D={n_dir} R={rows} '
          f'H={hidden} kernel/plain ms: K5 {fwd["kernel"]:.3f}/'
          f'{fwd["plain"]:.3f} ({1e3 * fwd["kernel"] / steps:.1f} us a '
          f'step; bound {out["bound_fwd"][0]:.3f}), K6 {bwd["kernel"]:.3f}/'
          f'{bwd["plain"]:.3f} (bound {out["bound_bwd"][0]:.3f})')
    return out


def idmse_service(arch, seed, device):
    """``EnhanceService(model_dir)`` over a model directory of the full-width
    ``arch`` with random weights from ``seed``, and its state_dict."""
    from brever_tpu_torch.models import ModelRegistry, count_params
    from brever_tpu_torch.serve import EnhanceService
    model = ModelRegistry.get(arch)(device='cpu')
    model.init_parameters(seed)
    state = model.state_dict()
    params, aux = model.to_flax(state), model.flax_aux(state)
    del model
    with tempfile.TemporaryDirectory() as tmp:
        service = EnhanceService(write_model_dir(
            os.path.join(tmp, 'model'), arch, params=params, aux=aux),
            device)
    if count_params(service.model) != IDMSE_PARAMS[arch]:
        raise AssertionError(f'{arch}: {count_params(service.model)} '
                             'parameters')
    return service, state


def denoiser_check(arch, gpu, state, device, seed):
    """The denoiser at 2 x 4 s against the plain path in float64 (and the
    plain float32 path's figure); checks one evaluation's K7 launches.
    Returns (dB, max abs err, plain float32 dB)."""
    from brever_tpu_torch.ops import groupnorm as gn
    rng = np.random.RandomState(seed)
    xs, ys = (complex_input(rng, (2, 1, 256, 501), device) for _ in range(2))
    t = torch.tensor([0.35, 0.8], device=device).reshape(2, 1, 1, 1)
    sigma = gpu.model.sde.sigma(t)
    with torch.no_grad():
        gn.group_norm_act_fwd.launches = 0
        got = gpu.model.model(xs, ys, sigma, t)
        torch.cuda.synchronize()
        per_eval = gn.group_norm_act_fwd.launches
        with plain_groupnorms():
            want = sgmse_model(state, device, torch.float64, arch).model(
                xs.to(torch.complex128), ys.to(torch.complex128),
                sigma.double(), t.double())
            plain = sgmse_model(state, device, arch=arch).model(xs, ys,
                                                                 sigma, t)
    if per_eval != IDMSE_EVAL_LAUNCHES[arch]:
        raise AssertionError(f'{arch}: {per_eval} K7 launches an '
                             f'evaluation, not {IDMSE_EVAL_LAUNCHES[arch]}')
    db, err = check_close(f'{arch} denoiser (2, 1, 256, 501)', ('d',),
                          (torch.view_as_real(want),),
                          (torch.view_as_real(got),))
    plain_db = check_close(f'{arch} plain denoiser', ('d',),
                           (torch.view_as_real(want),),
                           (torch.view_as_real(plain),), 0.0, None)[0]
    torch.cuda.empty_cache()
    return db, err, plain_db


def idmse_phases(device, card):
    """Phases 37-41: IDMSE (``idmse``, the ADM U-Net: the external-affine
    GroupNorms on the plain route, every other GroupNorm on K7/K8) served,
    differentiated, trained and timed, and ``idmselarge``'s denoiser,
    enhance and train step; returns the numbers of the records."""
    from brever_tpu_torch.checkpoint import load_checkpoint
    from brever_tpu_torch.ops import groupnorm as gn
    from brever_tpu_torch.profile_train import make_trainer
    from brever_tpu_torch.serve import EnhanceService
    out = {}
    torch.cuda.empty_cache()
    k7, k8 = gn.group_norm_act_fwd, gn.group_norm_act_bwd
    per_eval = IDMSE_EVAL_LAUNCHES['idmse']

    # ---- phase 37: denoiser, enhance and HTTP vs the plain path in float64
    gpu, state = idmse_service('idmse', 37, device)
    den_db, den_err, den_plain_db = denoiser_check('idmse', gpu, state,
                                                   device, 37)
    ref64 = sgmse_model(state, device, torch.float64, 'idmse')
    # 1 x 2 s (the smoke's time limit: 1 x 4 s before the norms' bf16
    # phases; each is a float64 solve)
    mix = (0.3 * np.random.RandomState(38).randn(1, 2, 2 * FS)) \
        .astype(np.float32)

    def enhance(model, audio=mix):
        return model.enhance(audio, generator=torch.Generator(
            device=device).manual_seed(0))

    k7.launches = 0
    got = enhance(gpu.model)
    torch.cuda.synchronize()
    enh_launches = k7.launches
    with plain_groupnorms():
        want = enhance(ref64)
    enh_db, enh_err = check_close('idmse enhance (1, 2, 32000)', ('wav',),
                                  (want,), (got,))
    evals = gpu.model.solver.evaluations
    if enh_launches != evals * per_eval:
        raise AssertionError(f'idmse enhance: {enh_launches} K7 launches, '
                             f'not {evals} x {per_eval}')
    del got, want
    results = []
    k7.launches = 0
    with http_service(gpu) as (port, health):
        if health['params'] != IDMSE_PARAMS['idmse'] \
                or health['arch'] != 'idmse':
            raise AssertionError(f'/health: {health}')
        for seconds in (0.05, 2):
            audio = (0.1 * np.random.RandomState(39).randn(
                int(seconds * FS))).astype(np.float32)
            before = k7.launches
            got = post_wav(port, audio)
            launched = k7.launches - before
            with plain_groupnorms():
                want = enhance(ref64, np.stack([audio, audio]))
            db, _ = check_close(f'idmse /enhance {seconds} s', ('wav',),
                                (want,), (torch.from_numpy(got)
                                          .to(device),))
            if launched != evals * per_eval:
                raise AssertionError(f'idmse /enhance {seconds} s: '
                                     f'{launched} K7 launches')
            results.append(f'{seconds} s {db:.1f} dB')
    out['launches_http'] = k7.launches
    del ref64
    torch.cuda.empty_cache()
    phase(37, f'IDMSE ({IDMSE_PARAMS["idmse"]:,} parameters) from '
          f'EnhanceService(model_dir): denoiser (2 x 4 s) {den_db:.1f} dB, '
          f'max abs err {den_err:.3e} vs the plain path in float64 (plain '
          f'float32 {den_plain_db:.1f} dB), {per_eval} K7 launches an '
          f'evaluation (its 20 external-affine GroupNorms on the plain '
          f'route); enhance (1 x 2 s, {evals} evaluations, generator seed 0 '
          f'on both paths) {enh_db:.1f} dB (>= {MIN_SNR_DB}), max abs err '
          f'{enh_err:.3e}, {enh_launches} K7 '
          f'launches; /health ok, /enhance {", ".join(results)} vs the '
          f'plain path in float64; {out["launches_http"]} K7 launches')

    # ---- phase 38: full-model gradients vs the plain path in float64
    rng = np.random.RandomState(40)
    target = 0.1 * rng.randn(2, 1, 2, 2 * FS)
    batch = torch.from_numpy(np.concatenate(
        [target + 0.1 * rng.randn(2, 1, 2, 2 * FS), target], axis=1)
        .astype(np.float32)).to(device)
    lengths = torch.tensor([2 * FS, 3 * FS // 2], device=device)
    t = torch.tensor([0.3, 0.9], device=device).reshape(2, 1, 1, 1)
    frames = gpu.model.transform(batch).shape[-1]
    noise = complex_input(rng, (2, 1, 256, frames), device, 1.0)
    with plain_groupnorms():
        ref = sgmse_grads(sgmse_model(state, device, torch.float64,
                                      'idmse'), batch, lengths, t,
                          noise)
        plain = sgmse_grads(sgmse_model(state, device, arch='idmse'), batch,
                            lengths, t, noise)
    k8.launches = k7.recompute_launches = 0
    got = sgmse_grads(gpu.model, batch, lengths, t, noise)
    launches_bwd, recomputes = k8.launches, k7.recompute_launches
    if launches_bwd != per_eval:
        raise AssertionError(f'idmse: {launches_bwd} K8 launches, not '
                             f'{per_eval}')
    k_whole, k_worst, k_name, k_dead = grad_report(ref, got)
    p_whole, p_worst, p_name, p_dead = grad_report(ref, plain)
    del ref, plain, got
    torch.cuda.empty_cache()
    if k_whole < MIN_SNR_DB or k_worst < MIN_SNR_DB or k_dead > 1e-6:
        raise AssertionError(f'idmse gradients: whole {k_whole:.2f} dB, '
                             f'worst {k_name} {k_worst:.2f} dB, zero '
                             f'tensors {k_dead:.1e}')
    phase(38, f'IDMSE gradients (2 x 2 s, t and noise fixed, remat) vs the '
          f'plain path in float64: whole {k_whole:.1f} dB (>= {MIN_SNR_DB}),'
          f' worst tensor {k_worst:.1f} dB ({k_name}; >= {MIN_SNR_DB}), '
          f'zero-gradient tensors within {k_dead:.1e} of the largest; the '
          f'plain float32 path: whole {p_whole:.1f} dB, worst '
          f'{p_worst:.1f} dB ({p_name}), zero {p_dead:.1e}; {launches_bwd} '
          f'K8 launches, {recomputes} K7 recomputes of rematerialised '
          'blocks')

    # ---- phase 39: training through train.main on the card
    from brever_tpu_torch import train
    epochs = 6
    with tempfile.TemporaryDirectory() as tmp:
        model_dir = tone_model_dir(tmp, 'idmse', 41)

        def args(n):   # validation scores the loss alone
            return train_args(model_dir, n, 1, '')

        untrained = train.build_trainer(args(epochs))
        untrained.init_state()
        untrained.val_dataloader.set_epoch(0)
        val_0, _ = untrained.routine(0, train=False)
        del untrained
        first, second, train_s, (out['launches_train'],
                                 out['launches_train_bwd'],
                                 out['recompute_train']) = \
            train_and_resume(args, epochs, [(k7, 'launches'),
                                            (k8, 'launches'),
                                            (k7, 'recompute_launches')])
        if not out['launches_train'] or not out['launches_train_bwd']:
            raise AssertionError('idmse training launched K7 {} and K8 {} '
                                 'times'.format(out['launches_train'],
                                                out['launches_train_bwd']))
        val = [v for v in first.loss_logger.val_loss if v is not None]
        losses = first.loss_logger.train_loss
        if not np.isfinite(val + losses).all() \
                or val[-1] > SGMSE_VAL_RATIO * val_0:
            raise AssertionError(f'idmse validation loss {val_0:.4f} -> '
                                 f'{val}')
        state_ckpt = load_checkpoint(second.last_ckpt_path)
        if not np.array_equal(
                state_ckpt['aux']['buffers']['emb']['fourier_freqs'],
                second.model.net.emb.fourier_freqs.cpu().numpy()) \
                or 'torch_generator' not in state_ckpt:
            raise AssertionError('last.ckpt lacks aux or the generator')
        served = EnhanceService(model_dir, device)
        audio = (0.1 * np.random.RandomState(42).randn(FS)) \
            .astype(np.float32)
        if not np.isfinite(served.enhance(audio)).all():
            raise AssertionError('the trained checkpoint serves non-finite '
                                 'audio')
        del first, second, served
    torch.cuda.empty_cache()
    phase(39, f'IDMSE train.main, 24 x 1 s tone-in-noise WAV items, batch '
          f'8, {epochs} epochs in {train_s:.1f} s: fixed-generator '
          f'validation loss {val_0:.4f} (untrained) -> '
          f'{", ".join(f"{v:.4f}" for v in val)} (last <= '
          f'{SGMSE_VAL_RATIO} x untrained); train loss '
          f'{", ".join(f"{v:.3f}" for v in losses)}; K7 '
          f'{out["launches_train"]} (of them {out["recompute_train"]} '
          f'recomputes) / K8 {out["launches_train_bwd"]} launches; resumed '
          f'bitwise from last.ckpt (aux, the generator\'s state) to epoch '
          f'{epochs + 2}; the checkpoint serves')

    # ---- phase 40: timings (plain, kernel, kernel, plain in turns)
    rng = np.random.RandomState(43)
    xs, ys = (complex_input(rng, (4, 1, 256, 501), device) for _ in range(2))
    t = torch.full((4, 1, 1, 1), 0.5, device=device)
    sigma = gpu.model.sde.sigma(t)

    def plain_gn(fn):
        def run():
            with plain_groupnorms():
                fn()
        return run

    def denoise():
        with torch.no_grad():
            gpu.model.model(xs, ys, sigma, t)

    den_ms, den_peak = in_turns({'kernel': denoise,
                                 'plain': plain_gn(denoise)}, 1, 1)
    # the external-affine GroupNorms of one evaluation, each timed on its
    # plain route, forward and backward
    from brever_tpu_torch.models.sgmse import net
    calls = {}

    def record(x, scale, bias, groups, eps=1e-6, apply_silu=True,
               ext_scale=None, ext_shift=None):
        if ext_scale is not None:
            key = (tuple(x.shape), groups, apply_silu)
            calls[key] = calls.get(key, 0) + 1
        return gn.group_norm_silu(x, scale, bias, groups, eps, apply_silu,
                                  ext_scale, ext_shift)

    net.group_norm_silu = record
    try:
        denoise()
    finally:
        net.group_norm_silu = gn.group_norm_silu
    ext = {'fwd': 0.0, 'bwd': 0.0, 'calls': sum(calls.values())}
    for (shape, groups, silu), count in calls.items():
        act = 'silu' if silu else 'none'
        x, scale, bias, dy = gn_inputs(rng, shape, device)
        gain, shift = (torch.from_numpy((1 + 0.1 * rng.randn(*shape[:2]))
                                        .astype(np.float32)).to(device)
                       for _ in range(2))
        args = (x, scale, bias, gain, shift, groups, 1e-6, act)
        with torch.no_grad():
            _, mean, rstd = gn.group_norm_ext_reference(*args)
            ext['fwd'] += count * cuda_ms(
                lambda: gn.group_norm_ext_reference(*args), 5, 1)
            ext['bwd'] += count * cuda_ms(
                lambda: gn.group_norm_ext_bwd_plain(
                    x, dy, scale, bias, gain, shift, mean, rstd, groups,
                    act), 5, 1)
        del x, dy, gain, shift, args, mean, rstd
    if ext['calls'] != 20:
        raise AssertionError(f'idmse: {ext["calls"]} external-affine '
                             'GroupNorms an evaluation')
    # 1 x 2 s (the smoke's time limit: 1 x 4 s before the bf16 phases)
    mix2 = torch.from_numpy((0.1 * rng.randn(1, 2, 2 * FS))
                            .astype(np.float32)).to(device)

    # 31 evaluations at cuDNN's default algorithm choice: one call
    torch.cuda.reset_peak_memory_stats()
    enh_ms = cuda_ms(lambda: gpu.model.enhance(mix2), 1, 0)
    enh_peak = torch.cuda.max_memory_allocated()
    del gpu, xs, ys, mix2
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        trainer, data, n = make_trainer(device, tmp, batch=4, arch='idmse')

        def step():
            trainer.train_step(data, n)

        step_ms, step_peak = in_turns({'kernel': step,
                                       'plain': plain_gn(step)}, 1, None)
        del trainer, data, n
    torch.cuda.empty_cache()
    out.update(den_ms=den_ms, enh_ms=enh_ms, step_ms=step_ms,
               step_peak=step_peak, ext=ext)
    mib = 2 ** 20
    phase(40, f'[{card}] IDMSE denoiser 4 x 4 s {den_ms["kernel"]:.2f} ms, '
          f'peak {den_peak["kernel"] / mib:.1f} MiB (plain GroupNorms '
          f'{den_ms["plain"]:.2f} ms); enhance 1 x 2 s '
          f'{enh_ms:.1f} ms, peak {enh_peak / mib:.1f} MiB; train step 4 x 4 '
          f's f32 '
          f'{step_ms["kernel"]:.1f} ms, peak {step_peak["kernel"] / mib:.1f} '
          f'MiB (plain GroupNorms {step_ms["plain"]:.1f} ms, '
          f'{step_peak["plain"] / mib:.1f} MiB); cuDNN\'s default algorithm '
          f'choice (benchmark mode off); the {ext["calls"]} external-affine '
          f'GroupNorms of an evaluation at 4 x 4 s on their plain route: '
          f'forward {ext["fwd"]:.2f} ms '
          f'({100 * ext["fwd"] / den_ms["kernel"]:.1f} % of the denoiser), '
          f'backward {ext["bwd"]:.2f} ms; forward twice (remat) and backward '
          f'{100 * (2 * ext["fwd"] + ext["bwd"]) / step_ms["kernel"]:.1f} % '
          'of the train step')

    # ---- phase 41: idmselarge: denoiser, enhance 1 x 2 s, one train step
    gpu, state = idmse_service('idmselarge', 44, device)
    big_db, big_err, big_plain_db = denoiser_check('idmselarge', gpu, state,
                                                   device, 44)
    mix2 = (0.3 * np.random.RandomState(45).randn(1, 2, 2 * FS)) \
        .astype(np.float32)
    plain32 = sgmse_model(state, device, arch='idmselarge')
    k7.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = enhance(gpu.model, mix2)
    torch.cuda.synchronize()
    big_enh_s = time.perf_counter() - t0
    big_enh_launches = k7.launches
    with plain_groupnorms():
        want = enhance(plain32, mix2)
    big_enh_db, _ = check_close('idmselarge enhance (1, 2, 32000)',
                                ('wav',), (want,), (got,))
    big_per_eval = IDMSE_EVAL_LAUNCHES['idmselarge']
    if big_enh_launches != gpu.model.solver.evaluations * big_per_eval:
        raise AssertionError(f'idmselarge enhance: {big_enh_launches} K7 '
                             'launches')
    del gpu, plain32, got, want
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        trainer, data, n = make_trainer(device, tmp, batch=4,
                                        arch='idmselarge')
        trainer.train_step(data, n)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        k7.launches = k8.launches = 0
        big_step_ms = cuda_ms(lambda: trainer.train_step(data, n), 1, 0)
        big_step_peak = torch.cuda.max_memory_allocated()
        big_step_launches = (k7.launches, k8.launches)
        del trainer, data, n
    torch.cuda.empty_cache()
    if big_step_launches[1] != big_per_eval:
        raise AssertionError(f'idmselarge step: launches {big_step_launches}')
    out.update(launches_large=big_enh_launches + sum(big_step_launches),
               large={'enhance_s': big_enh_s, 'step_ms': big_step_ms,
                      'step_peak': big_step_peak})
    phase(41, f'[{card}] IDMSE-large ({IDMSE_PARAMS["idmselarge"]:,} '
          f'parameters) from EnhanceService(model_dir): denoiser (2 x 4 s) '
          f'{big_db:.1f} dB, max abs err {big_err:.3e} vs the plain path in '
          f'float64 (plain float32 {big_plain_db:.1f} dB), {big_per_eval} '
          f'K7 launches an evaluation; enhance 1 x 2 s {big_enh_s:.2f} s '
          f'(cuDNN\'s default algorithms), {big_enh_db:.1f} dB vs the plain '
          f'float32 path on the same generator, {big_enh_launches} K7 '
          f'launches; one train step 4 x 4 s f32 {big_step_ms:.1f} ms, peak '
          f'{big_step_peak / mib:.1f} MiB, K7 {big_step_launches[0]} (with '
          f'recomputes) / K8 {big_step_launches[1]} launches')
    return out


#: the model settings of the Conv-TasNet whose blocks take the plain block
#: (phase 42): the default widths with 5 taps
OFF_KERNEL_MODEL = {'kernel_size': 5}


def kernel_size_phase(device, card):
    """Phase 42: a full-width Conv-TasNet whose depthwise convs have 5 taps
    serves through ``EnhanceService(model_dir)`` and trains through
    ``train.main`` on the card on plain blocks (no K1 or K2 launch, as the
    JAX package runs such blocks on XLA), against the CPU path."""
    from brever_tpu_torch.checkpoint import load_checkpoint
    from brever_tpu_torch.models import ModelRegistry
    from brever_tpu_torch.models.base import sample_weighted_mean
    from brever_tpu_torch.ops import tcn_block as tcn
    from brever_tpu_torch.serve import EnhanceService, build_model
    taps = dict(OFF_KERNEL_MODEL)
    model = ModelRegistry.get('convtasnet')(**taps, device='cpu')
    model.init_parameters(42)
    params = model.to_flax(model.state_dict())
    del model
    with tempfile.TemporaryDirectory() as tmp:
        model_dir = write_model_dir(os.path.join(tmp, 'model'), 'convtasnet',
                                    params=params, model=taps)
        gpu = EnhanceService(model_dir, device)
        cpu = EnhanceService(model_dir, 'cpu')
    if gpu.model.tcn.blocks[0].depthwise.weight.shape[0] != taps['kernel_size']:
        raise AssertionError('the served model does not have 5 taps')
    mix = (0.1 * np.random.RandomState(42).randn(2, 2, 4 * FS)) \
        .astype(np.float32)
    tcn.tcn_block.launches = tcn.tcn_block_bwd.launches = 0
    out = gpu.model.enhance(mix)
    results = []
    with http_service(gpu) as (port, health):
        if health['device'] != str(device):
            raise AssertionError(f'/health: {health}')
        audio = (0.1 * np.random.RandomState(43).randn(2 * FS)) \
            .astype(np.float32)
        got = post_wav(port, audio)
        snr_http, _ = check_output('/enhance 2 s, 5 taps', cpu.enhance(audio),
                                   got)
    torch.cuda.synchronize()
    serve_launches = tcn.tcn_block.launches
    snr, err = check_output('enhance (2, 2, 64000), 5 taps',
                            cpu.model.enhance(mix).numpy(),
                            out.cpu().numpy())
    results.append(f'enhance (2, 2, 64000) {snr:.1f} dB, /enhance 2 s '
                   f'{snr_http:.1f} dB')
    del gpu
    # one loss gradient on the card against the CPU path, both float32
    rng = np.random.RandomState(44)
    target = 0.1 * rng.randn(2, 1, 2, 2 * FS)
    batch = np.concatenate([target + 0.1 * rng.randn(2, 1, 2, 2 * FS),
                            target], axis=1).astype(np.float32)
    lengths = np.array([2 * FS, 3 * FS // 2], np.int32)
    grads = []
    for dev in ('cpu', device):
        model = build_model('convtasnet', taps, params, dev)
        n = torch.from_numpy(lengths).to(dev)
        loss = sample_weighted_mean(model.loss(torch.from_numpy(batch)
                                               .to(dev), n), n)
        grads.append(np.concatenate([g.double().cpu().numpy().ravel() for g in
                                     torch.autograd.grad(
                                         loss, list(model.parameters()))]))
        del model
    grad_snr = snr_db(*grads)
    if grad_snr < MIN_SNR_DB:
        raise AssertionError(f'5-tap gradients on the card: {grad_snr:.1f} '
                             f'dB against the CPU path (>= {MIN_SNR_DB})')
    epochs = 6
    with tempfile.TemporaryDirectory() as tmp:
        model_dir = tone_model_dir(tmp, 'convtasnet', 45, model=taps)
        first, second, train_s, (k1, k2) = train_and_resume(
            lambda n: train_args(model_dir, n, 3), epochs,
            [(tcn.tcn_block, 'launches'), (tcn.tcn_block_bwd, 'launches')])
        losses = first.loss_logger.train_loss
        if not np.isfinite(losses).all():
            raise AssertionError(f'5-tap training losses {losses}')
        served = build_model('convtasnet', taps,
                             load_checkpoint(second.last_ckpt_path)['params'],
                             device)
        mix1 = second.val_dataset[0][0][None]
        torch.testing.assert_close(served.enhance(mix1),
                                   second.model.enhance(mix1), atol=1e-6,
                                   rtol=1e-5)
        del first, second, served
    if (serve_launches, k1, k2) != (0, 0, 0):
        raise AssertionError(f'5-tap model launched K1 {serve_launches} + '
                             f'{k1} and K2 {k2} times')
    phase(42, f'Conv-TasNet at kernel_size {taps["kernel_size"]} (plain blocks) '
          f'on the card: {", ".join(results)} vs the CPU path; loss gradient '
          f'{grad_snr:.1f} dB (>= {MIN_SNR_DB}) vs the CPU path; train.main '
          f'{epochs} epochs in {train_s:.1f} s, train loss {losses[0]:.2f} -> '
          f'{losses[-1]:.2f} dB, resumed bitwise, the checkpoint serves; K1 '
          f'{serve_launches + k1} and K2 {k2} launches (the kernels take 3 '
          'taps)')
    torch.cuda.empty_cache()


FFNN_PARAMS = 1_509_440
#: a short FFNN training run's loss (the mel mask's mse) must end at most
#: at this fraction of its first epoch's (phase 44)
FFNN_LOSS_RATIO = 0.9
#: the metric twins on the card against themselves in float64 on the CPU:
#: the JAX twin's own bounds against its host metric (phase 46)
STOI_ATOL, PESQ_ATOL = 2e-3, 5e-3
#: wideband PESQ of a signal against itself, the published maximum, and
#: the JAX twin's bound on it
PESQ_WB_MAX, PESQ_MAX_ATOL = 4.643888749336258, 2e-3
#: phase 46's validation batch: 16 x 4 s at ragged lengths (0.25 s, both
#: sides of a 10 kHz frame edge, hop-aligned and not) and SNRs
METRIC_LENGTHS = (64000, 63999, 60001, 56000, 48000, 40000, 32001, 24000,
                  16000, 12000, 8192, 6401, 6400, 5000, 4000, 64000)
METRIC_SNRS = (20, 10, 5, 0, -5)


def kernel_counters():
    """Every kernel wrapper's launch counter, ``(function, attribute)``."""
    from brever_tpu_torch.ops import (batchnorm, fma_chain, groupnorm,
                                      lstm_scan, stft_kernel, tcn_block)
    return [(tcn_block.tcn_block, 'launches'),
            (tcn_block.tcn_block_bwd, 'launches'),
            (lstm_scan.lstm_scan_x, 'launches'),
            (lstm_scan.lstm_scan_x_bwd, 'launches'),
            (lstm_scan.lstm_scan, 'launches'),
            (lstm_scan.lstm_scan_bwd, 'launches'),
            (groupnorm.group_norm_act_fwd, 'launches'),
            (groupnorm.group_norm_act_bwd, 'launches'),
            (batchnorm.batch_norm_act_fwd, 'launches'),
            (batchnorm.batch_norm_act_bwd, 'launches'),
            (stft_kernel.stft_fused, 'launches'),
            (stft_kernel.stft_fused, 'dense_launches'),
            (fma_chain.fma_chain, 'launches')]


def ffnn_model(state, device, dtype=torch.float32):
    """The default ``ffnn`` on ``device`` in ``dtype`` holding a state_dict
    (``stats`` included), in eval mode."""
    from brever_tpu_torch.models import ModelRegistry
    model = ModelRegistry.get('ffnn')(device='cpu')
    model.load_state_dict(state)
    return model.to(device=device, dtype=dtype).eval()


def tone_sources(rng, batch, seconds):
    """``(batch, 2 sources, 2 channels, n)`` float32: a tone (the target)
    and the tone in white noise at about 0 dB."""
    n = int(seconds * FS)
    t = np.arange(n) / FS
    clean = 0.5 * np.sin(2 * np.pi * rng.uniform(100, 400, (batch, 1, 1, 1))
                         * t + rng.uniform(0, 2 * np.pi, (batch, 1, 1, 1)))
    clean = np.repeat(clean, 2, axis=2)
    return np.concatenate([clean + 0.35 * rng.randn(batch, 1, 2, n), clean],
                          axis=1).astype(np.float32)


def ffnn_loss_grads(model, batch, lengths):
    """Per-item loss (eval mode: no dropout) and the parameters' gradients
    of the weighted mean, in the model's dtype on its device."""
    from brever_tpu_torch.models.base import sample_weighted_mean
    model.eval()
    dtype = model.mean.dtype
    per_item = model.loss(batch.to(dtype), lengths)
    grads = torch.autograd.grad(sample_weighted_mean(per_item, lengths),
                                list(model.parameters()))
    return per_item.detach(), grads


def ffnn_phases(device):
    """Phases 43-45: FFNN (no kernel of its own) serves and trains on the
    card, no kernel wrapper launching."""
    from brever_tpu_torch.batching import BatchSamplerRegistry
    from brever_tpu_torch.checkpoint import load_checkpoint
    from brever_tpu_torch.data import BreverDataLoader, BreverDataset
    from brever_tpu_torch.models import ModelRegistry, count_params
    from brever_tpu_torch.serve import EnhanceService, build_model
    counters = kernel_counters()

    # ---- phase 43: FFNN from flax weights and stats on the card
    rng = np.random.RandomState(43)
    model = ModelRegistry.get('ffnn')(device='cpu')
    model.init_parameters(43)
    data = tone_sources(rng, 4, 2.0)
    model.pre_train(None, [(data, np.full(4, 2 * FS))], 1)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    params, aux = model.to_flax(state), model.flax_aux(state)
    del model
    with tempfile.TemporaryDirectory() as tmp:
        model_dir = write_model_dir(os.path.join(tmp, 'model'), 'ffnn',
                                    params=params, aux=aux)
        gpu = EnhanceService(model_dir, device)
        cpu = EnhanceService(model_dir, 'cpu')
    if count_params(gpu.model) != FFNN_PARAMS:
        raise AssertionError(f'FFNN: {count_params(gpu.model)} parameters')
    if not torch.equal(gpu.model.std.cpu(), state['std']):
        raise AssertionError('FFNN: the served model lacks aux[\'stats\']')
    ref = ffnn_model(state, 'cpu', torch.float64)
    mix = (0.1 * rng.randn(4, 2, 4 * FS)).astype(np.float32)
    for fn, attr in counters:
        setattr(fn, attr, 0)
    enhanced = gpu.model.enhance(mix)
    sources = torch.from_numpy(tone_sources(rng, 4, 4.0))
    feats = gpu.model.transform(sources.to(device))
    lengths = torch.tensor([4 * FS, 3 * FS, 2 * FS + 123, 0])
    items, grads = ffnn_loss_grads(gpu.model, sources.to(device),
                                   lengths.to(device))
    torch.cuda.synchronize()
    launches = sum(getattr(fn, attr) for fn, attr in counters)
    snr, err = check_output('FFNN enhance (4, 2, 64000)',
                            ref.enhance(mix).numpy(), enhanced.cpu().numpy())
    cpu_snr, _ = check_output('FFNN enhance (4, 2, 64000) vs CPU',
                              cpu.model.enhance(mix).numpy(),
                              enhanced.cpu().numpy())
    want = ref.transform(sources.double())
    n_in = ref.input_size
    feat_db, feat_err = check_close(
        'FFNN transform', ['features', 'labels'],
        [want[:, :n_in], want[:, n_in:]], [feats[:, :n_in].cpu(),
                                           feats[:, n_in:].cpu()])
    ref_items, ref_grads = ffnn_loss_grads(ref, sources, lengths)
    loss_db, _ = check_close('FFNN loss', ['per item'], [ref_items],
                             [items.cpu()])
    grad_db, grad_err = check_close(
        'FFNN gradients', [k for k, _ in ref.named_parameters()], ref_grads,
        [g.cpu() for g in grads])
    if launches:
        raise AssertionError(f'FFNN launched {launches} port kernels')
    del cpu, ref
    phase(43, f'FFNN ({FFNN_PARAMS:,} parameters, logfbe x 6 stacks, MLP '
          f'1024-1024, stats from pre_train) from EnhanceService(model_dir):'
          f' enhance (4, 2, 64000) SNR {snr:.2f} dB, max abs err {err:.3e} vs'
          f' the same model in float64 on the CPU ({cpu_snr:.2f} dB vs the '
          f'CPU service); transform of (4, 2, 2, 64000) {feat_db:.1f} dB, max '
          f'abs err {feat_err:.3e} (features and IRM labels); eval-mode loss '
          f'{loss_db:.1f} dB, gradients worst tensor {grad_db:.1f} dB, max abs'
          f' err {grad_err:.3e} (>= {MIN_SNR_DB} dB, <= {MAX_REL_ERR} of the '
          f'largest); {launches} kernel launches (STFT, filterbank and MLP '
          'are cuFFT and cuBLAS)')

    # ---- phase 44: pre_train on the card, train.main from the untouched
    # default config, resume
    epochs, val_period = 12, 4
    with tempfile.TemporaryDirectory() as tmp:
        model_dir = tone_model_dir(tmp, 'ffnn', 44)
        dataset = BreverDataset(path=os.path.join(tmp, 'train'))
        batches = list(BreverDataLoader(
            dataset, BatchSamplerRegistry.get('sorted')(
                dataset=dataset, batch_size=8, shuffle=False),
            pad_to_multiple=FS // 2))
        stats = []
        for dev, dtype in ((device, torch.float32), ('cpu', torch.float64)):
            model = ModelRegistry.get('ffnn')(device=dev).to(dtype)
            model.pre_train(None, batches, 1)
            stats.append([model.mean.cpu(), model.std.cpu()])
        stats_db, stats_err = check_close('FFNN pre_train', ['mean', 'std'],
                                          stats[1], stats[0])
        first, second, train_s, train_launches = train_and_resume(
            lambda n: [model_dir, '--device', 'cuda', '--epochs', str(n),
                       '--val_period', str(val_period)], epochs, counters)
        if first.use_ema or not first.device_val_metrics \
                or first.val_metrics != {'estoi', 'pesq', 'snr'}:
            raise AssertionError('the trainer did not take the default '
                                 'config')
        losses = first.loss_logger.train_loss
        last = float(np.mean(losses[-3:]))
        if not np.isfinite(losses).all() \
                or last > FFNN_LOSS_RATIO * losses[0]:
            raise AssertionError(f'FFNN training loss {losses[0]:.4f} -> '
                                 f'{last:.4f}')
        metrics = [m for m in first.loss_logger.metrics if m]
        if len(metrics) != epochs // val_period \
                or sorted(metrics[-1]) != ['estoi', 'pesq', 'snr'] \
                or not all(np.isfinite(v) for v in metrics[-1].values()):
            raise AssertionError(f'FFNN validation metrics {metrics}')
        ckpt = load_checkpoint(second.last_ckpt_path)
        if not np.array_equal(ckpt['aux']['stats']['std'],
                              second.model.std.cpu().numpy()) \
                or not (ckpt['aux']['stats']['std'] != 1).any():
            raise AssertionError('last.ckpt lacks the pre_train stats')
        if any(train_launches):
            raise AssertionError(f'FFNN training launched {train_launches}')
        served = build_model('ffnn', {}, ckpt['params'], device, ckpt['aux'])
        item = second.val_dataset[0][0][None]
        torch.testing.assert_close(served.enhance(item),
                                   second.model.enhance(item), atol=1e-6,
                                   rtol=1e-5)
        phase(44, f'FFNN pre_train on the card vs float64 on the CPU: '
              f'{stats_db:.1f} dB, max abs err {stats_err:.3e}; train.main '
              f'from the untouched config/models/ffnn.yaml (only --device, '
              f'--epochs, --val_period), 24 x 1 s tone-in-noise WAV items, '
              f'{epochs} epochs in {train_s:.1f} s: train loss '
              f'{losses[0]:.4f} -> {last:.4f} (mse; <= {FFNN_LOSS_RATIO} x),'
              f' val estoi {metrics[-1]["estoi"]:.4f} pesq '
              f'{metrics[-1]["pesq"]:.3f} snr {metrics[-1]["snr"]:.2f} dB '
              f'(device twins on the card, {len(metrics)} validations); '
              f'resumed bitwise (stats from aux[\'stats\']) from last.ckpt '
              f'to epoch {second.epochs_ran}; the checkpoint serves; 0 kernel'
              ' launches')
        del first, second, served

        # ---- phase 45: the HTTP service over the model directory
        service = EnhanceService(model_dir, device)
        ref = ffnn_model(service.model.state_dict(), 'cpu', torch.float64)
        results = []
        with http_service(service) as (port, health):
            if health['params'] != FFNN_PARAMS or health['arch'] != 'ffnn':
                raise AssertionError(f'/health: {health}')
            for seconds in (0.05, 4):
                audio = (0.1 * np.random.RandomState(45).randn(
                    int(seconds * FS))).astype(np.float32)
                got = post_wav(port, audio)
                snr, _ = check_output(f'FFNN /enhance {seconds} s',
                                      ref.enhance(np.stack([audio, audio]))
                                      .numpy(), got)
                results.append(f'{seconds} s {snr:.1f} dB')
        phase(45, f'FFNN /health ok, /enhance {", ".join(results)} from '
              'EnhanceService(model_dir) on the trained last.ckpt (its '
              'stats) vs the same model in float64 on the CPU')
        del service, ref



def ffnn_times(device, card):
    """Phase 47: FFNN's f32 train step at 32 s of audio a batch (8 x 4 s,
    its config's ``batch_size: 32`` with ``dynamic_batch_size``) and its
    peak memory; ``enhance`` of 1 x 4 s and 16 x 4 s."""
    from brever_tpu_torch.profile_train import make_trainer
    out = {}
    torch.cuda.empty_cache()
    # what earlier phases still hold stays out of the step's peak
    held = torch.cuda.memory_allocated()
    with tempfile.TemporaryDirectory() as tmp:
        trainer, data, lengths = make_trainer(device, tmp, 47, batch=8,
                                              arch='ffnn')
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out['step_ms'] = cuda_ms(lambda: trainer.train_step(data, lengths),
                                 20)
        out['step_peak'] = torch.cuda.max_memory_allocated() - held
        model = trainer.model.eval()
        for batch in (1, 16):
            x = data[:1, 0].expand(batch, -1, -1).contiguous()
            out[f'enhance_{batch}'] = cuda_ms(lambda: model.enhance(x), 20)
        del trainer, data, model
    torch.cuda.empty_cache()
    phase(47, f'[{card}] FFNN f32 train step at 8 x 4 s (32 s of audio, the '
          f'config\'s batch_size): {out["step_ms"]:.3f} ms, peak '
          f'{out["step_peak"] / 2 ** 20:.1f} MiB above the '
          f'{held / 2 ** 20:.1f} MiB earlier phases hold; enhance 1 x 4 s '
          f'{out["enhance_1"]:.3f} ms, 16 x 4 s {out["enhance_16"]:.3f} ms')
    return out


def metric_batch(rng):
    """``(deg, ref, lengths)``: the validation batch of phases 46 and 48,
    16 voiced tones of ``METRIC_LENGTHS`` in noise at ``METRIC_SNRS``,
    float64, zero past each length (time-aligned candidates)."""
    lengths = np.array(METRIC_LENGTHS)
    n_max = int(lengths.max())
    t = np.arange(n_max) / FS
    env = np.clip(np.sin(2 * np.pi * 2.5 * t), 0, None)
    ref = np.zeros((len(lengths), n_max))
    deg = np.zeros((len(lengths), n_max))
    for i, n in enumerate(lengths):
        f0 = rng.uniform(120, 260)
        clean = env[:n] * (np.sin(2 * np.pi * f0 * t[:n])
                           + 0.5 * np.sin(2 * np.pi * 3.9 * f0 * t[:n])
                           + 0.2 * np.sin(2 * np.pi * 8.2 * f0 * t[:n]))
        clean += 0.01 * rng.randn(n)
        snr = METRIC_SNRS[i % len(METRIC_SNRS)]
        ref[i, :n] = clean
        deg[i, :n] = clean + rng.randn(n) * np.sqrt(
            np.mean(clean ** 2) / 10 ** (snr / 10))
    return deg, ref, lengths


def metric_phase(device, card):
    """Phase 46: the validation-metric twins on a batch of 16 x 4 s at ragged
    lengths on the card against the same twins in float64 (on the card: on
    the host they took 35-57 s of the smoke), the identity PESQ, and each
    metric's ms for that batch."""
    from brever_tpu_torch import metrics_device as twins
    deg, ref, lengths = metric_batch(np.random.RandomState(46))
    x = torch.from_numpy(deg).float().to(device)
    y = torch.from_numpy(ref).float().to(device)
    n_dev = torch.from_numpy(lengths).to(device)
    metrics = {
        'stoi': (twins.stoi_device, STOI_ATOL),
        'estoi': (twins.estoi_device, STOI_ATOL),
        'pesq': (twins.pesq_device, PESQ_ATOL),
        'pesq_nb': (lambda a, b, n: twins.pesq_device(a, b, n, mode='nb'),
                    PESQ_ATOL),
        'snr': (twins.DEVICE_METRICS['snr'], None),
    }
    out, notes = {'err': {}, 'ms': {}}, []
    for name, (fn, atol) in metrics.items():
        got = fn(x, y, n_dev)
        want = fn(torch.from_numpy(deg).to(device),
                  torch.from_numpy(ref).to(device), n_dev).cpu()
        got = got.cpu().double()
        if got.shape != (len(lengths),) or not torch.isfinite(got).all():
            raise AssertionError(f'{name} on the card: {got}')
        err = (got - want).abs().max().item()
        if atol is None:
            atol = 1e-4 * want.abs().max().item()
        if err > atol:
            raise AssertionError(f'{name} on the card: {err:.3e} from float64'
                                 f' (<= {atol})')
        out['err'][name] = err
        out['ms'][name] = cuda_ms(lambda: fn(x, y, n_dev), 5, warmup=1)
        notes.append(f'{name} {err:.1e} ({got.min():.3f}..{got.max():.3f}) '
                     f'{out["ms"][name]:.2f} ms')
    identity = twins.pesq_device(y[:1], y[:1]).item()
    if abs(identity - PESQ_WB_MAX) > PESQ_MAX_ATOL:
        raise AssertionError(f'identity PESQ {identity}')
    phase(46, f'[{card}] metric twins on a validation batch of 16 x 4 s at '
          f'ragged lengths (0.25-4 s, 20 to -5 dB) on the card vs float64 '
          f'(on the card), max abs err (range) and ms a batch: '
          f'{"; ".join(notes)} '
          f'(bounds: STOI {STOI_ATOL}, PESQ {PESQ_ATOL} MOS); identity '
          f'wideband PESQ {identity:.6f} ({PESQ_WB_MAX})')
    return out


METRICGAN_PARAMS = {'metricganp': 1_914_524, 'metricganokd': 2_172_329}
#: K5 launches of one MetricGAN enhance: the inference generator's two
#: BLSTMs (B rows each, under the 128-row floor)
METRICGAN_K5_A_CALL = 2
#: K5 / K6 launches of one GAN update of one generator: its two BLSTMs in
#: its loss's forward and again when the updated generator recomputes the
#: enhanced magnitudes; K6 in the loss's backward
METRICGAN_K5_AN_UPDATE, METRICGAN_K6_AN_UPDATE = 4, 2
#: phase 52: a test set's output-side scores of the card's model against
#: the float64 CPU model's, both scored by the host twins: STOI and ESTOI,
#: PESQ (MOS) and SNR / SI-SNR (dB). The two outputs differ by ~1e-6 of
#: the signal (>= 60 dB); PESQ's alignment is a discrete search, so it
#: gets the widest bound
TEST_MODEL_ATOL = {'pesq': 1e-2, 'stoi': 1e-3, 'estoi': 1e-3, 'snr': 1e-2,
                   'sisnr': 1e-2}
TEST_MODEL_METRICS = ['pesq', 'stoi', 'estoi', 'snr', 'sisnr']
#: phase 52: ``--device_metrics`` scores against the host twins' on the
#: same outputs. The device PESQ aligns by one global delay where the host
#: realigns each utterance and bad interval: on 0 dB tone-in-noise items
#: (and a random model's output) the two part by more than on phase 48's
#: voiced items, so PESQ gets 2e-2 MOS; STOI and ESTOI keep the twins' 2e-3
TEST_MODEL_TWIN_ATOL = {'pesq': 2e-2, 'stoi': 2e-3, 'estoi': 2e-3,
                        'snr': 1e-3, 'sisnr': 1e-3}


def host_metric_phase(device, card):
    """Phase 48: the host twins (float64, PESQ's realignment) on phase 46's
    16 x 4 s ragged batch: ms a batch serially and through the spawn pool,
    the pool's size and start-up; the device twins on the card against
    them on these time-aligned candidates, within the twins' bounds."""
    from brever_tpu_torch import metrics as host
    from brever_tpu_torch import metrics_device as twins
    from brever_tpu_torch import pesq as pesq_mod
    deg, ref, lengths = metric_batch(np.random.RandomState(48))
    pesq_mod.close_pool()
    size = min(os.cpu_count() or 1, 8)
    t0 = time.perf_counter()
    pool = pesq_mod._get_pool(size)
    if pool is not None:
        pool.map(abs, range(size))
    startup = time.perf_counter() - t0
    x = torch.from_numpy(deg).float().to(device)
    y = torch.from_numpy(ref).float().to(device)
    n_dev = torch.from_numpy(lengths).to(device)
    cases = {
        'stoi': (host.stoi, {}, twins.stoi_device, STOI_ATOL),
        'estoi': (host.estoi, {}, twins.estoi_device, STOI_ATOL),
        'pesq': (host.pesq, {'mode': 'wb'}, twins.pesq_device, PESQ_ATOL),
        'pesq_nb': (host.pesq, {'mode': 'nb'},
                    lambda a, b, n: twins.pesq_device(a, b, n, mode='nb'),
                    PESQ_ATOL),
    }
    out = {'pool_size': size if pool is not None else 0,
           'pool_startup_s': startup, 'first_pool_ms': {}, 'pool_ms': {},
           'serial_ms': {}, 'gap': {}}
    notes = []
    for name, (fn, kwargs, twin, atol) in cases.items():
        times = []
        for _ in range(2):
            t0 = time.perf_counter()
            pooled = fn(deg, ref, lengths=lengths, **kwargs)
            times.append(1e3 * (time.perf_counter() - t0))
        t0 = time.perf_counter()
        serial = fn(deg, ref, batched=False, lengths=lengths, **kwargs)
        out['serial_ms'][name] = 1e3 * (time.perf_counter() - t0)
        out['first_pool_ms'][name], out['pool_ms'][name] = times
        if not np.array_equal(serial, pooled, equal_nan=True):
            raise AssertionError(f'{name}: the pool and the serial path '
                                 'differ')
        on_card = twin(x, y, n_dev).double().cpu().numpy()
        gap = float(np.max(np.abs(on_card - pooled)))
        if not gap <= atol:
            raise AssertionError(f'{name}: the device twin is {gap:.3e} '
                                 f'from the host twin (<= {atol})')
        out['gap'][name] = gap
        notes.append(f'{name} {out["serial_ms"][name]:.0f} ms serial, '
                     f'{times[1]:.0f} pooled (first {times[0]:.0f}), twin '
                     f'gap {gap:.1e}')
    phase(48, f'[{card}] host twins on 16 x 4 s at ragged lengths (0.25-4 s,'
          f' 20 to -5 dB), float64 on the host: {"; ".join(notes)} (bounds:'
          f' STOI {STOI_ATOL}, PESQ {PESQ_ATOL} MOS); spawn pool of '
          f'{out["pool_size"]} workers started in {startup:.2f} s')
    return out


def gan_descent(before, after, args, loss_d):
    """``(loss_d, after's)``: the discriminator's loss that a GAN update
    took its gradient of, and the same loss at the updated parameters
    from the same starting state (``before``'s BatchNorm statistics and
    spectral-norm ``u``, the updated generators' enhanced magnitudes)."""
    model = copy.deepcopy(before)
    names = dict(model.named_parameters())
    model.load_state_dict({k: v for k, v in after.state_dict().items()
                           if k in names}, strict=False)
    batch, scores, aug = args
    with torch.no_grad():
        noisy, clean = model._split_batch(batch)
        noisy_mag = model._stft_mag_phase(noisy)[0]
        clean_mag = model._stft_mag_phase(clean)[0]
        enh = [g(noisy_mag) for g in model.generators]
        updated = model._discriminator_loss(noisy_mag, clean_mag, enh, aug,
                                            scores, True)
    return loss_d, float(updated)


def metricgan_state(arch, seed):
    """A default ``arch`` drawn from ``seed`` on the CPU, its discriminator
    state moved off its initial values by one train-mode call: ``(model,
    state_dict)``."""
    from brever_tpu_torch.models import ModelRegistry
    model = ModelRegistry.get(arch)(device='cpu')
    model.init_parameters(seed)
    mag = torch.rand(2, 257, 40, generator=torch.Generator().manual_seed(
        seed))
    model.discriminator(mag, mag.flip(-1), train=True)
    return model, {k: v.clone() for k, v in model.state_dict().items()}


def metricgan_phases(device, card):
    """Phases 49-51: MetricGAN+ and MetricGAN-OKD served, one GAN update
    against float64, and MetricGAN+ trained from its untouched config."""
    from brever_tpu_torch import train
    from brever_tpu_torch.checkpoint import load_checkpoint
    from brever_tpu_torch.models import ModelRegistry, count_params
    from brever_tpu_torch.models import metricgan
    from brever_tpu_torch.ops import lstm_scan as lstm
    from brever_tpu_torch.profile_train import _Items
    from brever_tpu_torch.serve import EnhanceService, build_model
    from brever_tpu_torch.training import BreverTrainer
    counters = kernel_counters()
    out = {'launches_serve': 0, 'launches_train': 0,
           'launches_train_bwd': 0}

    # ---- phase 49: both keys from EnhanceService(model_dir)
    rng = np.random.RandomState(49)
    notes = []
    for k, arch in enumerate(('metricganp', 'metricganokd')):
        model, state = metricgan_state(arch, 49 + k)
        params, aux = model.to_flax(state), model.flax_aux(state)
        del model
        with tempfile.TemporaryDirectory() as tmp:
            model_dir = write_model_dir(os.path.join(tmp, 'model'), arch,
                                        params=params, aux=aux)
            gpu = EnhanceService(model_dir, device)
        if count_params(gpu.model) != METRICGAN_PARAMS[arch]:
            raise AssertionError(f'{arch}: {count_params(gpu.model)} '
                                 'parameters')
        if not all(torch.equal(v.cpu(), state[key]) for key, v in
                   gpu.model.state_dict().items()):
            raise AssertionError(f'{arch}: the served model lacks its '
                                 'batch_stats')
        ref = ModelRegistry.get(arch)(device='cpu')
        ref.load_state_dict(state)
        ref = ref.double().eval()
        mix = (0.1 * rng.randn(4, 2, 4 * FS)).astype(np.float32)
        for fn, attr in counters:
            setattr(fn, attr, 0)
        enhanced = gpu.model.enhance(mix)
        torch.cuda.synchronize()
        launched = [getattr(fn, attr) for fn, attr in counters]
        k5 = lstm.lstm_scan.launches
        if k5 != METRICGAN_K5_A_CALL or sum(launched) != k5:
            raise AssertionError(f'{arch} enhance launched {launched}')
        out['launches_serve'] += k5
        snr, err = check_output(f'{arch} enhance (4, 2, 64000)',
                                ref.enhance(mix).numpy(),
                                enhanced.cpu().numpy())
        http = []
        with http_service(gpu) as (port, health):
            if health['params'] != METRICGAN_PARAMS[arch] \
                    or health['arch'] != arch:
                raise AssertionError(f'/health: {health}')
            for seconds in (0.05, 4):
                audio = (0.1 * rng.randn(int(seconds * FS))) \
                    .astype(np.float32)
                before = lstm.lstm_scan.launches
                got = post_wav(port, audio)
                if lstm.lstm_scan.launches - before != METRICGAN_K5_A_CALL:
                    raise AssertionError(f'{arch} /enhance {seconds} s: '
                                         f'{lstm.lstm_scan.launches - before}'
                                         ' K5 launches')
                out['launches_serve'] += METRICGAN_K5_A_CALL
                http_snr, _ = check_output(
                    f'{arch} /enhance {seconds} s',
                    ref.enhance(np.stack([audio, audio])).numpy(), got)
                http.append(f'{seconds} s {http_snr:.1f} dB')
        notes.append(f'{arch} ({METRICGAN_PARAMS[arch]:,} parameters) '
                     f'{snr:.2f} dB, max abs err {err:.3e}, {k5} K5 launches;'
                     f' /enhance {", ".join(http)}')
        if arch == 'metricganp':
            out['enhance_1'] = cuda_ms(lambda: gpu.model.enhance(mix[:1]),
                                       10)
            batch16 = np.concatenate([mix] * 4)
            out['enhance_16'] = cuda_ms(lambda: gpu.model.enhance(batch16),
                                        5)
        del gpu, ref
    phase(49, f'MetricGAN from EnhanceService(model_dir) (flax params and '
          f'batch_stats; two BLSTMs of 200 units, 224 in K5): enhance (4, 2, '
          f'64000) vs the same model in float64 on the CPU: '
          f'{"; ".join(notes)}')

    # ---- phase 50: one GAN update at 4 x 4 s on the card vs float64
    sources = tone_sources(np.random.RandomState(50), 4, 4.0)
    scores = {'noisy': rng.rand(4, 1), 'enh': rng.rand(1, 4, 1),
              'aug': rng.rand(4, 1)}
    aug = sources[:, 1].mean(-2) + 0.01 * rng.randn(4, 4 * FS)
    items = _Items(4, 4.0)
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, dev, dtype in (('card', device, torch.float32),
                                 ('f64', 'cpu', torch.float64)):
            model = ModelRegistry.get('metricganp')(device='cpu').to(dtype)
            trainer = BreverTrainer(model, items, items,
                                    os.path.join(tmp, name), device=dev,
                                    val_metrics={'snr'}, seed=50)
            trainer.init_state()
            before = copy.deepcopy(trainer.model)
            args = (torch.from_numpy(sources).to(dev, dtype),
                    {k: torch.from_numpy(v).to(dev, dtype)
                     for k, v in scores.items()},
                    torch.from_numpy(aug).to(dev, dtype))
            for fn, attr in counters:
                setattr(fn, attr, 0)
            loss = trainer.model.update(trainer, *args)
            if dev == device:
                torch.cuda.synchronize()
                launched = [getattr(fn, attr) for fn, attr in counters]
                step_k5, step_k6 = (lstm.lstm_scan.launches,
                                    lstm.lstm_scan_bwd.launches)
                descent = gan_descent(before, trainer.model, args,
                                      float(loss['loss_d']))
            runs[name] = (trainer, loss)
    (card_tr, card_loss), (ref_tr, ref_loss) = runs['card'], runs['f64']
    if (step_k5, step_k6) != (METRICGAN_K5_AN_UPDATE,
                              METRICGAN_K6_AN_UPDATE) \
            or sum(launched) != step_k5 + step_k6:
        raise AssertionError(f'a GAN update launched {launched}')
    out['launches_train'] += step_k5
    out['launches_train_bwd'] += step_k6
    loss_db, _ = check_close('GAN losses', list(ref_loss),
                             [ref_loss[k].reshape(1) for k in ref_loss],
                             [card_loss[k].reshape(1).cpu()
                              for k in ref_loss])
    parts = [('generator', card_tr.optimizer['generators'][0],
              ref_tr.optimizer['generators'][0]),
             ('discriminator', card_tr.optimizer['discriminator'],
              ref_tr.optimizer['discriminator'])]
    grad_db, grad_err = check_close(
        'GAN gradients (Adam first moments)', [p[0] for p in parts],
        [p[2].mu for p in parts], [p[1].mu.cpu() for p in parts])
    ref_sd, card_sd = ref_tr.model.state_dict(), card_tr.model.state_dict()
    state_keys = [k for k in ref_sd if '.spectral.' in k
                  or k.endswith(('norm.mean', 'norm.var'))]
    state_db, state_err = check_close(
        'discriminator state', state_keys, [ref_sd[k] for k in state_keys],
        [card_sd[k].cpu() for k in state_keys])
    del runs, card_tr, ref_tr
    if not descent[1] < descent[0]:
        raise AssertionError(f'the discriminator\'s update raised its loss '
                             f'{descent[0]:.6f} -> {descent[1]:.6f}')
    # device_metric_scoring: the whole step on the card, no host scorer
    model = ModelRegistry.get('metricganp')(device_metric_scoring=True,
                                            device='cpu')

    def forbidden(*args, **kwargs):
        raise AssertionError('the host scorer ran with device scoring on')

    model._score = forbidden
    with tempfile.TemporaryDirectory() as tmp:
        trainer = BreverTrainer(model, items, items, tmp, device=device,
                                val_metrics={'snr'}, seed=50)
        trainer.init_state()
        data = torch.from_numpy(sources).to(device)
        n = torch.full((4,), 4 * FS, device=device)
        before = lstm.lstm_scan.launches, lstm.lstm_scan_bwd.launches
        dev_loss = trainer.train_step(data, n)
        torch.cuda.synchronize()
        out['launches_train'] += lstm.lstm_scan.launches - before[0]
        out['launches_train_bwd'] += lstm.lstm_scan_bwd.launches - before[1]
    if not all(torch.isfinite(v) for v in dev_loss.values()):
        raise AssertionError(f'device-scored step: {dev_loss}')
    del trainer, model
    phase(50, f'one GAN update of MetricGAN+ at 4 x 4 s (given scores and '
          f'augmented signal) on the card vs float64 on the CPU: losses '
          f'{loss_db:.1f} dB (loss_g {float(card_loss["loss_g"]):.4f}, loss_d'
          f' {float(card_loss["loss_d"]):.4f}), clipped gradients (Adam\'s '
          f'first moments) of the generator and the discriminator worst '
          f'{grad_db:.1f} dB, max abs err {grad_err:.3e}, BatchNorm '
          f'statistics and {len(state_keys) - 2} spectral-norm u/sigma '
          f'{state_db:.1f} dB, max abs err {state_err:.3e} (>= {MIN_SNR_DB} '
          f'dB, <= {MAX_REL_ERR} of the largest); the update lowers the '
          f'discriminator\'s loss on its batch {descent[0]:.6f} -> '
          f'{descent[1]:.6f}; {step_k5} K5 / {step_k6} K6 launches, no '
          f'K3/K4; a train step with device_metric_scoring '
          f'(candidates, PESQ targets by the device twin) never called the '
          f'host scorer: loss_g {float(dev_loss["loss_g"]):.4f}, loss_d '
          f'{float(dev_loss["loss_d"]):.4f}')

    # ---- phase 51: train.main from the untouched metricganp.yaml
    epochs, val_period = 16, 8
    calls = []
    host_metrics = metricgan._host_metrics

    def counting(names, fs):
        score = host_metrics(names, fs)

        def wrapped(deg, ref, lengths):
            calls.append(np.asarray(deg).shape[0])
            return score(deg, ref, lengths)
        return wrapped

    first_calls = []
    metricgan._host_metrics = counting
    tmp = tempfile.mkdtemp()
    try:
        model_dir = tone_model_dir(tmp, 'metricganp', 51)
        first, second, train_s, launched = train_and_resume(
            lambda n: [model_dir, '--device', 'cuda', '--epochs', str(n),
                       '--val_period', str(val_period)], epochs, counters,
            after_first=lambda: first_calls.extend(calls))
    finally:
        metricgan._host_metrics = host_metrics
    k5, k6 = (launched[[fn for fn, _ in counters].index(f)]
              for f in (lstm.lstm_scan, lstm.lstm_scan_bwd))
    if k5 == 0 or k6 == 0 or sum(launched) != k5 + k6:
        raise AssertionError(f'MetricGAN training launched {launched}')
    out['launches_train'] += k5
    out['launches_train_bwd'] += k6
    if first.use_ema or not first.device_val_metrics \
            or first.val_metrics != {'estoi', 'pesq', 'snr'} \
            or not first.model.precompute_metric \
            or first.model.device_metric_scoring \
            or first.model.target_metrics != ['pesq']:
        raise AssertionError('the trainer did not take the default config')
    steps = len(first.train_batch_sampler)
    val_steps = len(first.val_batch_sampler) * (epochs // val_period)
    singles = sum(1 for c in first_calls if c == 1)
    batched = sum(1 for c in first_calls if c > 1)
    if singles != epochs * len(first.train_dataset) \
            or batched != 2 * steps * epochs + 3 * val_steps:
        raise AssertionError(f'host scorer calls: {singles} single, '
                             f'{batched} batched')
    losses = first.loss_logger.train_loss
    loss_d = [x['loss_d'] for x in losses]
    loss_g = [x['loss_g'] for x in losses]
    last_d = float(np.mean(loss_d[-3:]))
    if not np.isfinite(loss_d + loss_g).all():
        raise AssertionError(f'MetricGAN losses {losses}')
    metrics = [m for m in first.loss_logger.metrics if m]
    if len(metrics) != epochs // val_period \
            or sorted(metrics[-1]) != ['estoi', 'pesq', 'snr'] \
            or not all(np.isfinite(v) for v in metrics[-1].values()):
        raise AssertionError(f'MetricGAN validation metrics {metrics}')
    ckpt = load_checkpoint(second.last_ckpt_path)
    stats = ckpt['aux']['batch_stats']['discriminator']
    if sorted(ckpt['opt_state']) != ['discriminator', 'generators'] \
            or len(ckpt['opt_state']['generators']) != 1 \
            or stats['SpectralNorm_0']['conv_0/kernel/u'].shape != (1, 15):
        raise AssertionError('last.ckpt lacks the GAN state')
    served = build_model('metricganp', {}, ckpt['params'], device,
                         ckpt['aux'])
    item = second.val_dataset[0][0][None]
    torch.testing.assert_close(served.enhance(item),
                               second.model.enhance(item), atol=1e-6,
                               rtol=1e-5)
    out['model_dir'] = model_dir
    out['tmp'] = tmp
    del first, second, served
    with tempfile.TemporaryDirectory() as okd_tmp:
        okd_dir = tone_model_dir(okd_tmp, 'metricganokd', 52)
        okd = train.main([okd_dir, '--device', 'cuda', '--epochs', '1',
                          '--val_period', '1'])
        okd_loss = okd.loss_logger.train_loss[0]
        if not all(np.isfinite(v) for v in okd_loss.values()) \
                or okd.model.n_generators != 1:
            raise AssertionError(f'MetricGAN-OKD: {okd_loss}')
        del okd
    phase(51, f'train.main from the untouched config/models/metricganp.yaml '
          f'(only --device, --epochs, --val_period), 24 x 1 s tone-in-noise '
          f'WAV items, {steps} GAN step(s) an epoch, {epochs} epochs in '
          f'{train_s:.1f} s: loss_d {loss_d[0]:.4f} -> {last_d:.4f} (min '
          f'{min(loss_d):.4f}, max {max(loss_d):.4f}: one step an epoch at lr'
          f' 1e-4 under a new augmentation SNR each step; phase 50 holds the'
          f' fall on a fixed batch), loss_g {loss_g[0]:.4f} -> '
          f'{float(np.mean(loss_g[-3:])):.4f}; host PESQ targets: {singles} '
          f'single-item calls in the loader (one an item an epoch), '
          f'{batched} batched calls (two a train step, three a validation '
          f'step); val estoi {metrics[-1]["estoi"]:.4f} pesq '
          f'{metrics[-1]["pesq"]:.3f} snr {metrics[-1]["snr"]:.2f} dB (device '
          f'twins); K5 {k5} / K6 {k6} launches; resumed bitwise (both '
          f'optimizers, aux[\'batch_stats\']) from last.ckpt to epoch '
          f'{epochs + 2}; the checkpoint serves; metricganokd\'s default '
          f'config one epoch: loss_g {okd_loss["loss_g"]:.4f}, loss_d '
          f'{okd_loss["loss_d"]:.4f}')
    return out


def test_model_phase(device, card, dirs):
    """Phase 52: ``test_model`` over MetricGAN+'s trained directory and
    Conv-TasNet's (K1 launches), host twins and ``--device_metrics``."""
    import importlib.util
    from brever_tpu_torch import metrics as host
    from brever_tpu_torch import test_model as tm
    from brever_tpu_torch.config import get_config
    from brever_tpu_torch.data import BreverDataLoader, BreverDataset
    from brever_tpu_torch.batching import SortedBatchSampler
    from brever_tpu_torch.ops import lstm_scan as lstm
    from brever_tpu_torch.ops import tcn_block as tcn
    write = importlib.util.find_spec('h5py') is not None
    out, notes = {'audio_s_per_s': {}}, []
    with tempfile.TemporaryDirectory() as tmp:
        test_set = os.path.join(tmp, 'test_set')
        write_tone_dataset(test_set, 6, 2.0, 52)
        for arch, model_dir in dirs:
            cfg = get_config(os.path.join(model_dir, 'config.yaml'))
            ckpt = os.path.join(model_dir, 'checkpoints', 'last.ckpt')
            model = tm.load_model(model_dir, ckpt, cfg, device)
            ref = tm.load_model(model_dir, ckpt, cfg, 'cpu').double()
            scores, seconds = {}, {}
            for device_metrics in (False, True):
                args = tm.parse_args(
                    ['-i', model_dir, '-t', test_set, '--force']
                    + (['--device_metrics'] if device_metrics else []))
                before = (tcn.tcn_block.launches, lstm.lstm_scan.launches)
                t0 = time.perf_counter()
                scores[device_metrics] = tm.test_model(
                    args, model, cfg, test_set,
                    os.path.join(model_dir, 'scores.hdf5'), ckpt,
                    TEST_MODEL_METRICS, write=write and not device_metrics)
                torch.cuda.synchronize()
                seconds[device_metrics] = time.perf_counter() - t0
                launched = (tcn.tcn_block.launches - before[0],
                            lstm.lstm_scan.launches - before[1])
            # the host twins run directly on the same items, and on the
            # float64 CPU model's output
            dataset = BreverDataset(test_set, fs=FS)
            batch, lengths = next(iter(BreverDataLoader(
                dataset, SortedBatchSampler(dataset, batch_size=20,
                                            shuffle=False, dynamic=True,
                                            reverse=True))))
            inputs, target = batch[:, 0].mean(-2), batch[:, 1].mean(-2)
            with torch.no_grad():
                want_out = ref._enhance(torch.from_numpy(
                    batch[:, 0]).double()).numpy()
            if want_out.ndim == 3:
                want_out = want_out[:, 0]
            gaps, twin_gaps = {}, {}
            for i, name in enumerate(TEST_MODEL_METRICS):
                fn = host.MetricRegistry.get(name)
                want_in = np.asarray(fn(inputs, target, lengths=lengths))
                got = scores[False][:, i]
                exact = name not in ('snr', 'sisnr')
                if (exact and not np.array_equal(got[:, 0], want_in)) or \
                        not np.allclose(got[:, 0], want_in, rtol=0,
                                        atol=1e-5):
                    raise AssertionError(f'{arch} {name}: input scores '
                                         f'{got[:, 0]} vs {want_in}')
                want = np.asarray(fn(want_out, target, lengths=lengths))
                gaps[name] = float(np.max(np.abs(got[:, 1] - want)))
                if not gaps[name] <= TEST_MODEL_ATOL[name]:
                    raise AssertionError(f'{arch} {name}: output scores '
                                         f'{gaps[name]:.3e} from float64')
                twin_gap = float(np.max(np.abs(scores[True][:, i]
                                               - scores[False][:, i])))
                twin_gaps[name] = twin_gap
                if not twin_gap <= TEST_MODEL_TWIN_ATOL[name]:
                    raise AssertionError(f'{arch} {name}: --device_metrics '
                                         f'{twin_gap:.3e} from the host')
            expected = (24 if arch == 'convtasnet' else 0,
                        METRICGAN_K5_A_CALL if arch == 'metricganp' else 0)
            if launched != expected:
                raise AssertionError(f'{arch} test_model launched '
                                     f'{launched}, not {expected}')
            if write:
                import h5py
                with h5py.File(os.path.join(model_dir, 'scores.hdf5'),
                               'r') as f:
                    shape = f['last.ckpt/test_set'].shape
                if shape != (6, len(TEST_MODEL_METRICS), 2):
                    raise AssertionError(f'scores.hdf5 holds {shape}')
            out['audio_s_per_s'][arch] = 12.0 / seconds[False]
            out['audio_s_per_s'][arch + '_device_metrics'] = \
                12.0 / seconds[True]
            notes.append(
                f'{arch} ({launched[0]} K1 / {launched[1]} K5 launches a '
                f'call) output vs float64: ' + ', '.join(
                    f'{k} {v:.1e}' for k, v in gaps.items())
                + '; --device_metrics vs the host: ' + ', '.join(
                    f'{k} {v:.1e}' for k, v in twin_gaps.items())
                + f'; {12.0 / seconds[False]:.1f} audio s/s (host twins), '
                f'{12.0 / seconds[True]:.1f} (--device_metrics)')
            del model, ref
    out['written'] = write
    phase(52, f'[{card}] test_model over 6 x 2 s tone-in-noise mixtures with '
          f'{" ".join(TEST_MODEL_METRICS)}: input-side scores equal to the '
          f'host twins run directly (bitwise; snr/sisnr within 1e-5 dB); '
          f'{"; ".join(notes)} (bounds: ' + ', '.join(
              f'{k} {v}' for k, v in TEST_MODEL_ATOL.items())
          + '; --device_metrics: ' + ', '.join(
              f'{k} {v}' for k, v in TEST_MODEL_TWIN_ATOL.items()) + '); '
          + ('scores.hdf5 written and read back' if write else
             'h5py is not installed here: the scores stop before '
             'scores.hdf5, whose write a CPU test holds'))
    return out


def metricgan_times(device, card, served, tested):
    """Phase 53: MetricGAN+'s step at its config's 32 s a batch (8 x 4 s)
    in three parts with the card's idle share and peak memory; enhance of
    1 x 4 s and 16 x 4 s; test_model's audio seconds a second."""
    from brever_tpu_torch import profile_train
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    prof = profile_train.profile(device, steps=3, arch='metricganp', batch=8)
    torch.cuda.empty_cache()
    parts = prof['step_parts_ms']
    phase(53, f'[{card}] MetricGAN+ GAN step at 8 x 4 s (32 s of audio, the '
          f'config\'s batch_size): {prof["train_step_batch_x4s_ms"]:.1f} ms '
          f'(candidates {parts["candidates"]:.1f}, host PESQ scoring '
          f'{parts["scoring"]:.1f}, the two updates {parts["updates"]:.1f} ms'
          f' on the host clock), card idle '
          f'{100 * prof["device_idle_share"]:.1f} %, peak {prof["peak_memory_mib"]:.1f} MiB (earlier phases hold '
          f'{held / 2 ** 20:.1f}); enhance 1 x 4 s {served["enhance_1"]:.2f} '
          f'ms, 16 x 4 s {served["enhance_16"]:.2f} ms; test_model '
          + ', '.join(f'{k} {v:.1f}' for k, v in
                      tested['audio_s_per_s'].items()) + ' audio s/s')
    return prof

#: K1-bf16/K2-bf16 against their plain twin on the card (phase 54): the SNR
#: of each output and gradient in dB. bf16 keeps 8 significant bits, so one
#: rounding of an output costs about 50 dB against float64 (the kernels and
#: the twin reach 50-56 dB); kernel and twin round at the same points but
#: sum in other float32 orders, which moves a rounding by one ulp at some
#: elements (66-94 dB between them in the first run on the card), while a
#: wrong fold, tap or rounding point costs tens of dB. An elementwise ulp
#: bound does not hold: an output near 0 is a cancelling float32 sum, off
#: by thousands of its own ulps where it is ~1e-5 of the tensor's scale
BF16_TWIN_DB = 40.0
#: no farther from float64 than the twin: each tensor's SNR against float64
#: at most this far under the twin's; a PReLU slope's gradient (one
#: number, whose one rounding is its whole error) within one bf16 ulp of
#: float64 more than the twin's
BF16_F64_SLACK_DB = 0.5
#: phase 54's cases: every dilation of the default model, and the last
#: block (no residual) at 128
BF16_CASES = [(2 ** i, False) for i in range(8)] + [(128, True)]
#: the default Conv-TasNet trained from its untouched config (phase 55):
#: FLAC items of 1 s (train, val), epochs, validation period
AMP_TRAIN = (8, 2, 8, 4)
#: K1's and K2's kernels (names as the profiler gives them), and the
#: launches of each in one call
K1_KERNELS = {'tcn_in_gemm': 1, 'row_stats': 2, 'dw_prelu_stats': 1,
              'tcn_out_gemm': 1}
K2_KERNELS = 11
#: the card's dense bf16 tensor-core rate (H100 SXM, NVIDIA's data sheet),
#: against which the bf16 route's bound is taken
BF16_FLOPS = 989e12

TCN_BF16_TRACE = """
import json
import torch
from brever_tpu_torch.numerics import disable_tf32
from brever_tpu_torch.ops import tcn_block as tcn

disable_tf32()
dev = torch.device('cuda', 0)
gen = torch.Generator(device=dev).manual_seed(55)


def rand(*shape, scale=0.1, center=0.0):
    return (center + scale * torch.randn(*shape, generator=gen, device=dev)
            ).to(torch.bfloat16)


c, h = 128, 512
x = rand(2, 400, c, scale=1.0)
params = (rand(h, c), rand(h), rand(1, center=0.25), rand(h, center=1.0),
          rand(h), rand(3, h, scale=0.5), rand(h), rand(1, center=0.25),
          rand(h, center=1.0), rand(h), rand(c, h), rand(c), rand(c, h),
          rand(c))
g_res, g_skip = rand(2, 400, c, scale=1.0), rand(2, 400, c, scale=1.0)
with torch.no_grad():
    _, _, stats = tcn.tcn_block_fwd(x, params, 4, False)


def names(fn):
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(3):
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        got = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        if got:
            break
    return got


with torch.no_grad():
    out = {'k1': names(lambda: tcn.tcn_block_fwd(x, params, 4, False)),
           'k2': names(lambda: tcn.tcn_block_bwd(x, params, stats, g_res,
                                                 g_skip, 4, False))}
print(json.dumps(out))
"""


def bf16_trace():
    """Starts tracing one K1-bf16 call and one K2-bf16 call in a fresh
    interpreter (the process: :func:`traced_kernels` waits for it)."""
    root = os.path.dirname(os.path.abspath(__file__))
    return subprocess.Popen([sys.executable, '-c', TCN_BF16_TRACE],
                            cwd=root, env=dict(os.environ, PYTHONPATH=root),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def traced_kernels(run):
    """The kernels the traced K1-bf16 and K2-bf16 calls of ``run`` launched;
    fails unless each launched only its own kernels, K1's five and K2's
    eleven ``tcn_bwd_*``, the templated ones at ``__nv_bfloat16`` where the
    profiler gives template arguments. Stops the process in any case."""
    try:
        stdout, stderr = run.communicate(timeout=600)
    finally:
        run.kill()
    if run.returncode:
        raise AssertionError(f'K1/K2-bf16 trace: {stderr[-3000:]}')
    traced = json.loads(stdout.strip().splitlines()[-1])
    k1, k2 = traced['k1'], traced['k2']
    counts = {k: sum(k in n for n in k1) for k in K1_KERNELS}
    wrong = [n for n in k1 + k2 if '<' in n and 'bfloat16' not in n
             and 'row_stats' not in n and 'row_merge' not in n]
    if counts != K1_KERNELS or len(k1) != sum(K1_KERNELS.values()) \
            or len(k2) != K2_KERNELS or not all('tcn_bwd_' in n for n in k2) \
            or wrong:
        raise AssertionError(f'K1-bf16 launched {k1}; K2-bf16 {k2}')
    return traced


def trace_or_none(fn, tries=3):
    """``fn()``, a breakdown read from a profiler trace, or None where the
    profiler recorded no device activity in ``tries`` traces (seen after
    many traces in one process; the numbers it gives are extras, the checks
    of phases 54-57 do not read a trace)."""
    for _ in range(tries):
        try:
            return fn()
        except RuntimeError as e:
            if 'no device activity' not in str(e) \
                    and 'lost device events' not in str(e):
                raise
    return None


def bf16_check(name, got, twin, exact):
    """``got`` (bf16) against its twin's ``twin`` (bf16) and float64
    ``exact``: finite, SNR against the twin >= BF16_TWIN_DB, and no
    farther from float64 than the twin (BF16_F64_SLACK_DB; one ulp for a
    single number). Returns (SNR vs twin, SNR vs float64, twin's)."""
    if got.dtype != torch.bfloat16 or got.shape != twin.shape:
        raise AssertionError(f'{name}: {got.dtype} {tuple(got.shape)}')
    got, twin, exact = (t.detach().double() for t in (got, twin, exact))
    if not torch.isfinite(got).all():
        raise AssertionError(f'{name}: not finite')

    def db(a, b):
        return snr_db(b.cpu().numpy(), a.cpu().numpy())

    vs_twin, vs_exact, twin_exact = db(got, twin), db(got, exact), \
        db(twin, exact)
    if got.numel() == 1:
        ulp = 2.0 ** (math.floor(math.log2(max(abs(exact.item()), 1e-30)))
                      - 7)
        farther = abs(got.item() - exact.item()) > abs(
            twin.item() - exact.item()) + ulp
    else:
        farther = vs_exact < twin_exact - BF16_F64_SLACK_DB
    if vs_twin < BF16_TWIN_DB or farther:
        raise AssertionError(f'{name}: SNR vs twin {vs_twin:.2f} dB (>= '
                             f'{BF16_TWIN_DB}), vs float64 {vs_exact:.2f} '
                             f'dB, the twin\'s {twin_exact:.2f} dB')
    return vs_twin, vs_exact, twin_exact


def amp_phases(device, card):
    """Phases 54-57: K1-bf16 and K2-bf16 against their twin and float64,
    their launches traced, the default Conv-TasNet trained under bf16 amp
    from its untouched config on FLAC, and the amp step timed against the
    float32 step. Returns what the kernels' JSON record reads."""
    import brever_tpu_torch.ops.tcn_block as tcn
    from brever_tpu_torch import profile_tcn_bwd, profile_train
    from brever_tpu_torch.models import count_params
    from brever_tpu_torch.profile_train import make_trainer
    bf = torch.bfloat16

    def cast(t, dtype=bf):
        return None if t is None else t.to(dtype)

    # ---- phase 54: K1-bf16/K2-bf16 vs the twin and float64
    rng = np.random.RandomState(54)
    gen = torch.Generator(device=device).manual_seed(54)
    worst_twin, worst_gap = float('inf'), -float('inf')
    out_err = bwd_err = 0.0
    for dilation, last in BF16_CASES:
        x, params = block_inputs(rng, 16, 3999)
        x, params = cast(x), [cast(p) for p in params]
        if last:
            params[10] = params[11] = None
        g_skip = cast(torch.randn(16, 3999, 128, generator=gen,
                                  device=device))
        g_res = None if last else cast(torch.randn(
            16, 3999, 128, generator=gen, device=device))
        wide = [cast(p, torch.float64) for p in params]
        label = f'K1-bf16 d={dilation} last={last}'
        with torch.no_grad():
            (res, skip, stats), act = tcn._launch(x, params, dilation, last)
            (res2, skip2, _), _ = tcn._launch(x, params, dilation, last)
            twin = tcn.tcn_block_fwd_plain(x, params, dilation, last)
            exact = tcn.tcn_block_fwd_plain(cast(x, torch.float64), wide,
                                            dilation, last)
            z1 = tcn.recompute_z1(x, params)
        if not torch.equal(skip, skip2) or (not last
                                            and not torch.equal(res, res2)):
            raise AssertionError(f'{label}: two runs differ')
        if not torch.equal(torch.where(z1 >= 0, z1, params[2].float() * z1),
                           act[0]):
            raise AssertionError(f'{label}: K2\'s z1 is not K1\'s')
        del z1, act
        outs = [('skip', skip, twin[1], exact[1])]
        if not last:
            outs.append(('res', res, twin[0], exact[0]))
        for part, got, want, ref in outs:
            vs_twin, vs_exact, twin_exact = bf16_check(
                f'{label} {part}', got, want, ref)
            worst_twin = min(worst_twin, vs_twin)
            worst_gap = max(worst_gap, twin_exact - vs_exact)
            out_err = max(out_err, (got.double() - want.double()).abs()
                          .max().item())
        del res2, skip2, twin, exact
        label = f'K2-bf16 d={dilation} last={last}'
        dx, dparams = tcn.tcn_block_bwd(x, params, stats, g_res, g_skip,
                                        dilation, last)
        again = tcn.tcn_block_bwd(x, params, stats, g_res, g_skip, dilation,
                                  last)
        for got, rerun in zip((dx,) + dparams, (again[0],) + again[1]):
            if got is not None and not torch.equal(got, rerun):
                raise AssertionError(f'{label}: two runs differ')
        del again
        twin = tcn.tcn_block_bwd_plain(x, params, g_res, g_skip, dilation,
                                       last)
        exact = tcn.tcn_block_bwd_plain(cast(x, torch.float64), wide,
                                        cast(g_res, torch.float64),
                                        cast(g_skip, torch.float64),
                                        dilation, last)
        for part, got, want, ref in zip(GRAD_NAMES, (dx,) + dparams,
                                        (twin[0],) + twin[1],
                                        (exact[0],) + exact[1]):
            if got is None:
                continue
            vs_twin, vs_exact, twin_exact = bf16_check(
                f'{label} {part}', got, want, ref)
            worst_twin = min(worst_twin, vs_twin)
            worst_gap = max(worst_gap, twin_exact - vs_exact)
            bwd_err = max(bwd_err, (got.double() - want.double()).abs()
                          .max().item())
        del dx, dparams, twin, exact
    torch.cuda.empty_cache()
    # times at B=16 T=3999 d=1, kernel and twin in turns, and each launch
    x, params = block_inputs(np.random.RandomState(4), 16, 3999)
    x, params = cast(x), [cast(p) for p in params]
    g_res = cast(torch.randn(16, 3999, 128, generator=gen, device=device))
    g_skip = cast(torch.randn(16, 3999, 128, generator=gen, device=device))
    with torch.no_grad():
        _, _, stats = tcn.tcn_block_fwd(x, params, 1, False)
        fwd_ms = in_turns({
            'kernel': lambda: tcn.tcn_block_fwd(x, params, 1, False),
            'plain': lambda: tcn.tcn_block_fwd_plain(x, params, 1, False)},
            5, 2)[0]
    bwd_ms = in_turns({
        'kernel': lambda: tcn.tcn_block_bwd(x, params, stats, g_res, g_skip,
                                            1, False),
        'plain': lambda: tcn.tcn_block_bwd_plain(x, params, g_res, g_skip,
                                                 1, False)}, 5, 2)[0]
    del x, params, g_res, g_skip, stats
    parts = {'k1': trace_or_none(lambda: profile_tcn_bwd.profile(
                 1, calls=3, forward=True, dtype=bf)),
             'k2': trace_or_none(lambda: profile_tcn_bwd.profile(
                 1, calls=3, dtype=bf))}
    torch.cuda.empty_cache()

    def parts_line(key):
        run = parts[key]
        if run is None:
            return 'launches not traced (the profiler recorded nothing)'
        return (f'{run["ms"]:.3f} ms, {run["launches"]:g} launches: '
                + ', '.join(f'{n.split("(")[0].split("::")[-1]} {ms:.3f}'
                            for n, ms in sorted(run['parts'].items(),
                                                key=lambda kv: -kv[1])))

    phase(54, f'{len(BF16_CASES)} bf16 block cases at B=16 T=3999 '
          f'C/H/Cs 128/512/128 (d 1..128, the last block at 128): K1-bf16 '
          f'res/skip and K2-bf16 dx and every bf16 parameter gradient agree '
          f'with the bf16 plain twin on the card (worst SNR '
          f'{worst_twin:.1f} dB >= {BF16_TWIN_DB}; max abs err outputs '
          f'{out_err:.3e}, gradients {bwd_err:.3e}) and are no farther from float64 than the twin '
          f'(at most {worst_gap:.2f} dB under it, <= {BF16_F64_SLACK_DB}); '
          f'two runs bitwise equal; K2\'s z1 bitwise K1\'s; [{card}] d=1 '
          f'kernel/twin ms: K1-bf16 {fwd_ms["kernel"]:.3f}/'
          f'{fwd_ms["plain"]:.3f}, K2-bf16 {bwd_ms["kernel"]:.3f}/'
          f'{bwd_ms["plain"]:.3f}; K1-bf16 {parts_line("k1")}; K2-bf16 '
          f'{parts_line("k2")}')

    # ---- phase 55: train.main from the untouched default config on FLAC,
    # while a fresh interpreter traces a K1-bf16 and a K2-bf16 call
    tracer = bf16_trace()
    try:
        train = amp_training(tcn, count_params)
    except BaseException:
        tracer.kill()
        raise
    traced = traced_kernels(tracer)
    phase(55, 'train.main from the untouched config/models/convtasnet.yaml '
          f'(use_amp: true; {N_PARAMS:,} parameters; only --device, --epochs '
          f'{train["epochs"]} and --val_period {train["val_period"]} given) '
          f'on FLAC tars ({train["items"]} tone-in-noise items of 1 s, the '
          f'port\'s encoder) in {train["seconds"]:.1f} s: train loss '
          f'{train["losses"][0]:.2f} -> {np.mean(train["losses"][-3:]):.2f} '
          f'dB, val snr {train["metrics"]["snr"]:.2f} dB, estoi '
          f'{train["metrics"]["estoi"]:.3f}, pesq '
          f'{train["metrics"]["pesq"]:.2f}; K1-bf16 {train["k1_bf16"]} / '
          f'K2-bf16 {train["k2_bf16"]} launches (K1 float32 '
          f'{train["k1_f32"]}: validation enhances with the float32 '
          'masters), no bf16 tensor in a plain twin on the card; resumed '
          f'bitwise from last.ckpt to epoch {train["resumed_to"]}')
    phase(56, f'a K1-bf16 call launches {len(traced["k1"])} kernels, all '
          f'K1\'s, a K2-bf16 call {len(traced["k2"])}, all tcn_bwd_* '
          '(traced in a fresh interpreter during phase 55): no library '
          'kernel')

    # ---- phase 57: the amp step against the float32 step, in turns
    with tempfile.TemporaryDirectory() as tmp:
        trainers = {key: make_trainer(device, os.path.join(tmp, key),
                                      use_amp=key == 'kernel')
                    for key in ('plain', 'kernel')}
        step_ms, step_peak = in_turns(
            {key: (lambda t=t: t[0].train_step(t[1], t[2]))
             for key, t in trainers.items()}, 3, 1)
        del trainers
    torch.cuda.empty_cache()
    prof = trace_or_none(lambda: profile_train.profile(device, steps=3,
                                                       use_amp=True))
    if prof is None:
        k1_step = k2_step = idle = None
        traced_step = 'not traced (the profiler recorded nothing)'
    else:
        per_step = prof['kernels_per_step'].items()
        k1_step = sum(v['ms'] for n, v in per_step
                      if any(k in n for k in K1_KERNELS))
        k2_step = sum(v['ms'] for n, v in per_step if 'tcn_bwd_' in n)
        idle = prof['device_idle_share']
        traced_step = (f'traced: K1-bf16 {k1_step:.2f} ms and K2-bf16 '
                       f'{k2_step:.2f} ms a step, device idle '
                       f'{100 * idle:.1f} %')
    phase(57, f'[{card}] Conv-TasNet train step 16 x 4 s, bf16 amp '
          f'{step_ms["kernel"]:.2f} ms (peak {step_peak["kernel"] / 2 ** 20:.0f}'
          f' MiB) vs float32 {step_ms["plain"]:.2f} ms (peak '
          f'{step_peak["plain"] / 2 ** 20:.0f} MiB), in turns; amp step '
          f'{traced_step}')
    return {'launches': (train['k1_bf16'], train['k2_bf16']),
            'fwd_ms': fwd_ms, 'bwd_ms': bwd_ms, 'parts': parts,
            'out_err': out_err, 'bwd_err': bwd_err,
            'worst_twin_db': worst_twin, 'step_ms': step_ms,
            'step_peak': step_peak, 'k1_step': k1_step, 'k2_step': k2_step,
            'idle': idle}


def amp_training(tcn, count_params):
    """Phase 55's run: the default Conv-TasNet trained by ``train.main``
    from its untouched config under bf16 amp on FLAC tars, and resumed;
    checks the launches, the loss and that no bf16 tensor reaches a plain
    twin on the card. Returns what the phase prints."""
    n_train, n_val, epochs, val_period = AMP_TRAIN
    seen = []

    def refuse(plain):
        def run(x, *args):
            if x.device.type == 'cuda':
                seen.append(plain.__name__)
            return plain(x, *args)
        return run

    saved = tcn._fwd_plain_bf16, tcn._bwd_plain_bf16
    tcn._fwd_plain_bf16, tcn._bwd_plain_bf16 = (refuse(f) for f in saved)
    with tempfile.TemporaryDirectory() as tmp:
        paths = []
        for split, n_items, seed in (('train', n_train, 56),
                                     ('val', n_val, 57)):
            paths.append(os.path.join(tmp, split))
            write_tone_dataset(paths[-1], n_items, 1.0, seed, ext='.flac')
        model_dir = write_model_dir(os.path.join(tmp, 'model'),
                                    'convtasnet', *paths)
        with open(os.path.join(CONFIG_DIR, 'convtasnet.yaml')) as f:
            untouched = f.read()
        if 'use_amp: true' not in untouched:
            raise AssertionError('convtasnet.yaml no longer sets use_amp')
        try:
            first, second, train_s, launches = train_and_resume(
                lambda n: [model_dir, '--device', 'cuda', '--epochs', str(n),
                           '--val_period', str(val_period)], epochs,
                [(tcn.tcn_block, 'launches'),
                 (tcn.tcn_block, 'launches_bf16'),
                 (tcn.tcn_block_bwd, 'launches'),
                 (tcn.tcn_block_bwd, 'launches_bf16')])
        finally:
            tcn._fwd_plain_bf16, tcn._bwd_plain_bf16 = saved
        k1_all, k1_bf16, k2_all, k2_bf16 = launches
        if not first.use_amp or count_params(first.model) != N_PARAMS \
                or first.flat.dtype != torch.float32:
            raise AssertionError('phase 55 did not train the default '
                                 'model under amp')
        if k1_bf16 == 0 or k2_bf16 == 0 or k2_all != k2_bf16 or seen:
            raise AssertionError(f'amp training launched K1 {k1_all} '
                                 f'({k1_bf16} bf16) and K2 {k2_all} '
                                 f'({k2_bf16} bf16); bf16 plain twin calls '
                                 f'on the card: {seen}')
        losses = first.loss_logger.train_loss
        if not np.isfinite(losses).all() \
                or np.mean(losses[-3:]) >= losses[0]:
            raise AssertionError(f'amp training loss {losses}')
        metrics = [m for m in first.loss_logger.metrics if m][-1]
    return {'epochs': epochs, 'val_period': val_period,
            'items': f'{n_train} + {n_val}', 'seconds': train_s,
            'losses': losses, 'metrics': metrics, 'k1_bf16': k1_bf16,
            'k2_bf16': k2_bf16, 'k1_f32': k1_all - k1_bf16,
            'resumed_to': second.epochs_ran}


#: K3-K6's bf16 route against its bf16 twin on the card: each tensor's SNR
#: at least this (dB), over the full scan
LSTM_BF16_TWIN_DB = 35.0
#: phase 58's K3/K4 cases: TF-GridNet's intra and inter BLSTMs at 16 x 4 s
#: and K4's hidden-size ends at ragged R; K5/K6 cases: DCCRN's two layers at
#: 16 x 4 s (gates projected from E), a short request's 8 rows, and H = 224
#: (MetricGAN's 200 on the kernels' grid): (T, D, R, E, H)
LSTM_BF16_X_CASES = [LSTM_INTRA, LSTM_INTER, *LSTM_EDGE_CASES]
LSTM_BF16_SCAN_CASES = [DCCRN_LSTM[0], DCCRN_LSTM[1], (33, 2, 8, 128, 128),
                        (20, 2, 40, 64, 224)]
#: the default TF-GridNet and DCCRN trained from their untouched configs
#: (phases 60, 61): FLAC items of 1 s (train, val), epochs, validation period
RNN_AMP_TRAIN = (8, 2, 2, 2)
#: the kernels of one call of each bf16 LSTM entry (names as the profiler
#: gives them) and their launches: K3-bf16 one, K4's five steps six (the partial sums of
#: dW and of db), K6's scan, weight GEMM (K4-bf16's) and its sum three
LSTM_BF16_KERNELS = {
    'k3': {'lstm_fwd_ring_mma': 1},
    'k4': {'lstm_bwd_gates_mma': 1, 'lstm_bwd_rscan_mma': 1,
           'lstm_bwd_dx_mma': 1, 'lstm_bwd_wgrad_mma': 1,
           'sum_partials': 2},
    'k5': {'lstm_scan_fwd_cluster': 1},
    'k6': {'lstm_scan_bwd_cluster': 1, 'lstm_bwd_wgrad_mma': 1,
           'sum_partials': 1}}

LSTM_BF16_TRACE = """
import json
import torch
from brever_tpu_torch.numerics import disable_tf32
from brever_tpu_torch.ops import lstm_scan as L

disable_tf32()
dev = torch.device('cuda', 0)
gen = torch.Generator(device=dev).manual_seed(59)


def rand(*shape, scale=1.0):
    return (scale * torch.randn(*shape, generator=gen, device=dev)
            ).to(torch.bfloat16)


def names(fn):
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(3):
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        got = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        if got:
            break
    return got


x, wi, b = rand(6, 2, 300, 128), rand(2, 128, 512, scale=0.09), rand(2, 512)
wh, dh = rand(2, 128, 512, scale=0.09), rand(6, 2, 300, 128)
gx, dhs = rand(33, 2, 32, 512), rand(33, 2, 32, 128)
with torch.no_grad():
    h, c = L.lstm_scan_x_fwd(x, wi, b, wh)
    hs, cs = L.lstm_scan_fwd(gx, wh)
    out = {'k3': names(lambda: L.lstm_scan_x_fwd(x, wi, b, wh)),
           'k4': names(lambda: L.lstm_scan_x_bwd(x, wi, b, wh, h, c, dh)),
           'k5': names(lambda: L.lstm_scan_fwd(gx, wh)),
           'k6': names(lambda: L.lstm_scan_bwd(gx, wh, hs, cs, dhs))}
print(json.dumps(out))
"""


def lstm_bf16_trace():
    """Starts tracing one call of each of K3-bf16, K4-bf16, K5-bf16 and
    K6-bf16 in a fresh interpreter (:func:`lstm_traced_kernels` waits)."""
    root = os.path.dirname(os.path.abspath(__file__))
    return subprocess.Popen([sys.executable, '-c', LSTM_BF16_TRACE],
                            cwd=root, env=dict(os.environ, PYTHONPATH=root),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def lstm_traced_kernels(run):
    """The kernels each traced bf16 LSTM call of ``run`` launched; fails
    unless each launched its own kernels in ``LSTM_BF16_KERNELS``' counts,
    the ones templated on the storage at ``__nv_bfloat16`` where the
    profiler gives template arguments (K3-bf16's and K4-bf16's ``*_mma``
    kernels are bf16 alone), and besides them only PyTorch's elementwise
    kernels (the wrapper's padding, transposed weight copies and its casts
    of the float32 weight gradients): no cuBLAS or cuDNN kernel. Stops the
    process in any case."""
    try:
        stdout, stderr = run.communicate(timeout=600)
    finally:
        run.kill()
    if run.returncode:
        raise AssertionError(f'bf16 LSTM trace: {stderr[-3000:]}')
    traced = json.loads(stdout.strip().splitlines()[-1])
    for key, want in LSTM_BF16_KERNELS.items():
        got = traced[key]
        ours = [n for n in got if any(k in n for k in want)]
        counts = {k: sum(k in n for n in got) for k in want}
        wrong = [n for n in ours if '<' in n and 'bfloat16' not in n
                 and '_mma' not in n]
        other = [n for n in got if n not in ours and 'at::native' not in n]
        if counts != want or wrong or other:
            raise AssertionError(f'{key.upper()}-bf16 launched {got}')
    return traced


def lstm_check(name, got, twin, exact, min_db=LSTM_BF16_TWIN_DB):
    """``got`` (bf16) against its twin's ``twin`` (bf16) and float64
    ``exact``, on the card: finite, SNR against the twin >= ``min_db`` and
    no farther from float64 than the twin (BF16_F64_SLACK_DB). Returns (SNR
    vs twin, SNR vs float64, twin's, max abs err vs the twin)."""
    if got.dtype != torch.bfloat16:
        raise AssertionError(f'{name}: {got.dtype} {tuple(got.shape)}')
    return twin_check(name, got, twin, exact, min_db)


def lstm_amp_phases(device, card):
    """Phases 58-62: K3-K6's bf16 route against its twin and float64 on the
    card, their launches traced, the default TF-GridNet and DCCRN trained
    under bf16 amp from their untouched configs on FLAC, and their amp
    steps timed against the float32 steps. Returns what the kernels' JSON
    records read."""
    from brever_tpu_torch import profile_train
    from brever_tpu_torch.ops import build
    from brever_tpu_torch.ops import lstm_scan as L
    from brever_tpu_torch.profile_lstm import (K4_PARTS, inputs, k4_parts,
                                               library_ms, mma_sass)
    from brever_tpu_torch.profile_train import make_trainer
    bf = torch.bfloat16
    out = {'worst_db': {}, 'err': {}, 'timing': {}}
    # K3-bf16's and K4-bf16's products on the bf16 tensor cores: HMMA with
    # BF16 operands in the SASS of each of their kernels
    out['hmma'] = mma_sass(build.build())
    if not all(out['hmma'].values()):
        raise AssertionError(f'K3-bf16/K4-bf16 SASS without bf16 HMMA: '
                             f'{out["hmma"]}')
    tracer = lstm_bf16_trace()
    try:
        # ---- phase 58: the bf16 kernels vs their twin and float64, and
        # their times at the main path's shapes (TF-GridNet's intra and
        # inter BLSTMs, DCCRN's first layer), kernel and twin in turns, with
        # cuDNN's bidirectional LSTM in bf16 as the library's yardstick
        gen = torch.Generator(device=device).manual_seed(58)
        worst = {k: float('inf') for k in ('k3', 'k4', 'k5', 'k6')}
        err = {k: 0.0 for k in worst}
        gap = -float('inf')
        timing = out['timing']

        def held(key, label, names, gots, twins, exacts):
            nonlocal gap
            for part, got, twin, exact in zip(names, gots, twins, exacts):
                vs_twin, vs_exact, twin_exact, e = lstm_check(
                    f'{key.upper()}-bf16 {label} {part}', got, twin, exact)
                worst[key] = min(worst[key], vs_twin)
                err[key] = max(err[key], e)
                gap = max(gap, twin_exact - vs_exact)

        for case in LSTM_BF16_X_CASES:
            label = 'T={} D={} R={} E={} H={}'.format(*case)
            x, w_ih, bias, w_hh, dh = inputs(gen, *case, bf, device)
            h, c = L.lstm_scan_x_fwd(x, w_ih, bias, w_hh)
            with torch.no_grad():
                h2, c2, gates = L.forward_gates(x, w_ih, bias, w_hh)
                gates4 = L.recompute_gates(x, w_ih, bias, w_hh, h)
            if not (torch.equal(h, h2) and torch.equal(c, c2)):
                raise AssertionError(f'K3-bf16 {label}: two runs differ')
            if not torch.equal(gates, gates4):
                raise AssertionError(f'K3-bf16 {label}: K4\'s recomputed '
                                     'gates are not K3\'s')
            del h2, c2, gates, gates4
            twin = L.lstm_scan_x_reference(x, w_ih, bias, w_hh)
            wide = [t.double() for t in (x, w_ih, bias, w_hh)]
            exact = L.lstm_scan_x_reference(*wide)
            held('k3', label, ('h', 'c'), (h, c), twin, exact)
            grads = L.lstm_scan_x_bwd(x, w_ih, bias, w_hh, h, c, dh)
            again = L.lstm_scan_x_bwd(x, w_ih, bias, w_hh, h, c, dh)
            if not all(torch.equal(a, b) for a, b in zip(grads, again)):
                raise AssertionError(f'K4-bf16 {label}: two runs differ')
            del again
            twin_g = L.lstm_scan_x_bwd_plain(x, w_ih, bias, w_hh, *twin, dh)
            del twin
            exact_g = L.lstm_scan_x_bwd_plain(*wide, *exact, dh.double())
            del exact, wide
            held('k4', label, LSTM_NAMES, grads, twin_g, exact_g)
            del grads, twin_g, exact_g
            torch.cuda.empty_cache()
            which = {LSTM_INTRA: 'intra', LSTM_INTER: 'inter'}.get(case)
            if which is not None:
                steps, n_dir, rows, feat, hidden = case
                with torch.no_grad():
                    fwd = in_turns({
                        'kernel': lambda: L.lstm_scan_x_fwd(x, w_ih, bias,
                                                            w_hh),
                        'plain': lambda: L.lstm_scan_x_reference(
                            x, w_ih, bias, w_hh)}, 3, 1)[0]
                    bwd = in_turns({
                        'kernel': lambda: L.lstm_scan_x_bwd(
                            x, w_ih, bias, w_hh, h, c, dh),
                        'plain': lambda: L.lstm_scan_x_bwd_plain(
                            x, w_ih, bias, w_hh, h, c, dh)}, 2, 1)[0]
                    # K4-bf16 launch by launch (a profiler trace)
                    parts = k4_parts(lambda: L.lstm_scan_x_bwd(
                        x, w_ih, bias, w_hh, h, c, dh))
                lib_fwd, lib_bwd = library_ms(x, feat, hidden, 3)
                # bf16 bounds: the float32 route's operations at the bf16
                # tensor-core rate, 2 bytes an element (the weight
                # gradients too)
                seq = steps * n_dir * rows
                flops = 2 * seq * 4 * hidden * (feat + hidden)
                weights = n_dir * 4 * hidden * (feat + hidden + 1)
                timing[which] = {
                    'fwd': fwd, 'bwd': bwd, 'lib_fwd': lib_fwd,
                    'lib_bwd': lib_bwd, 'parts': parts,
                    'bound_fwd': bound(flops, 2 * (seq * (feat + 2 * hidden)
                                                   + weights), BF16_FLOPS),
                    'bound_bwd': bound(3 * flops, 2 * (
                        seq * (2 * feat + 3 * hidden) + 2 * weights),
                        BF16_FLOPS)}
            del x, w_ih, bias, w_hh, dh, h, c
            torch.cuda.empty_cache()
        for case in LSTM_BF16_SCAN_CASES:
            steps, n_dir, rows, feat, hidden = case
            label = f'T={steps} D={n_dir} R={rows} H={hidden} (gates from ' \
                f'E={feat})'
            x, w_ih, bias, w_hh, dh = inputs(gen, *case, bf, device)
            gates_x = (torch.einsum('tdre,dek->tdrk', x, w_ih)
                       + bias[None, :, None]).contiguous()
            h, c = L.lstm_scan_fwd(gates_x, w_hh)
            h2, c2 = L.lstm_scan_fwd(gates_x, w_hh)
            if not (torch.equal(h, h2) and torch.equal(c, c2)):
                raise AssertionError(f'K5-bf16 {label}: two runs differ')
            twin = L.lstm_scan_reference(gates_x, w_hh)
            wide = [t.double() for t in (gates_x, w_hh)]
            exact = L.lstm_scan_reference(*wide)
            held('k5', label, ('h', 'c'), (h, c), twin, exact)
            grads = L.lstm_scan_bwd(gates_x, w_hh, h, c, dh)
            again = L.lstm_scan_bwd(gates_x, w_hh, h, c, dh)
            if not all(torch.equal(a, b) for a, b in zip(grads, again)):
                raise AssertionError(f'K6-bf16 {label}: two runs differ')
            twin_g = L.lstm_scan_bwd_plain(gates_x, w_hh, *twin, dh)
            exact_g = L.lstm_scan_bwd_plain(*wide, *exact, dh.double())
            held('k6', label, ('dgates', 'dw_hh'), grads, twin_g, exact_g)
            del h2, c2, twin, wide, exact, grads, again, twin_g, exact_g
            if case == DCCRN_LSTM[0]:
                with torch.no_grad():
                    fwd = in_turns({
                        'kernel': lambda: L.lstm_scan_fwd(gates_x, w_hh),
                        'plain': lambda: L.lstm_scan_reference(gates_x,
                                                               w_hh)},
                        3, 1)[0]
                    bwd = in_turns({
                        'kernel': lambda: L.lstm_scan_bwd(gates_x, w_hh, h,
                                                          c, dh),
                        'plain': lambda: L.lstm_scan_bwd_plain(
                            gates_x, w_hh, h, c, dh)}, 2, 1)[0]
                lib_fwd, lib_bwd = library_ms(x, feat, hidden, 3)
                seq = steps * n_dir * rows
                flops = 2 * seq * 4 * hidden * hidden
                weights = n_dir * 4 * hidden * hidden
                timing['dccrn'] = {
                    'fwd': fwd, 'bwd': bwd, 'lib_fwd': lib_fwd,
                    'lib_bwd': lib_bwd,
                    'bound_fwd': bound(flops, 2 * (seq * 6 * hidden
                                                   + weights), BF16_FLOPS),
                    'bound_bwd': bound(3 * flops, 2 * (
                        seq * 11 * hidden + 2 * weights), BF16_FLOPS)}
            del x, w_ih, bias, w_hh, dh, gates_x, h, c
        torch.cuda.empty_cache()
        out['worst_db'], out['err'] = worst, err

        def lib(t, key):
            return 'n/a' if t[key] is None else f'{t[key]:.3f}'

        t3, t5 = timing['intra'], timing['dccrn']
        split = '; '.join(
            f'{w} ' + ' '.join(f'{p} {timing[w]["parts"][p]:.3f}'
                               for p, *_ in K4_PARTS)
            for w in ('intra', 'inter'))
        phase(58, f'{len(LSTM_BF16_X_CASES)} K3/K4 and '
              f'{len(LSTM_BF16_SCAN_CASES)} K5/K6 bf16 cases (TF-GridNet '
              f'intra {LSTM_INTRA} and inter {LSTM_INTER}, H=32 and 256 at '
              f'ragged R; DCCRN\'s layers {DCCRN_LSTM}, 8 rows, H=224): h, c '
              f'and every gradient agree with the bf16 twin on the card '
              f'over the full scan (worst SNR K3 {worst["k3"]:.1f}, K4 '
              f'{worst["k4"]:.1f}, K5 {worst["k5"]:.1f}, K6 '
              f'{worst["k6"]:.1f} dB >= {LSTM_BF16_TWIN_DB}) and are no '
              f'farther from float64 than the twin (at most {gap:.2f} dB '
              f'under it, <= {BF16_F64_SLACK_DB}); two runs bitwise equal; '
              f'K4-bf16\'s recomputed gates bitwise K3-bf16\'s; [{card}] '
              f'kernel/twin/nn.LSTM-bf16 ms: intra K3 '
              f'{t3["fwd"]["kernel"]:.3f}/{t3["fwd"]["plain"]:.3f}/'
              f'{lib(t3, "lib_fwd")} K4 {t3["bwd"]["kernel"]:.3f}/'
              f'{t3["bwd"]["plain"]:.3f}/{lib(t3, "lib_bwd")}, inter K3 '
              f'{timing["inter"]["fwd"]["kernel"]:.3f} K4 '
              f'{timing["inter"]["bwd"]["kernel"]:.3f}; DCCRN layer 0 K5 '
              f'{t5["fwd"]["kernel"]:.3f}/{t5["fwd"]["plain"]:.3f}/'
              f'{lib(t5, "lib_fwd")} K6 {t5["bwd"]["kernel"]:.3f}/'
              f'{t5["bwd"]["plain"]:.3f}/{lib(t5, "lib_bwd")}; K4-bf16\'s '
              f'launches ms: {split}; bf16 HMMA in the SASS of '
              + ', '.join(f'{k} {n}' for k, n in out['hmma'].items()))

        # ---- phases 60-61: train.main from the untouched configs, while
        # the fresh interpreter traces the bf16 calls
        out['train'] = {arch: rnn_amp_training(arch, L)
                        for arch in ('tfgridnet', 'dccrn')}
    except BaseException:
        tracer.kill()
        raise
    traced = lstm_traced_kernels(tracer)
    phase(59, 'one call each of K3-bf16, K4-bf16, K5-bf16 and K6-bf16 '
          'traced in a fresh interpreter (run during phases 58-61) launches '
          + ', '.join(f'{len([n for n in traced[k] if "at::native" not in n])}'
                      f' ({k.upper()})' for k in LSTM_BF16_KERNELS)
          + ' of its own kernels (K3-bf16 and K4-bf16 the bf16 tensor-core '
          '*_mma kernels, the others at __nv_bfloat16), and no cuBLAS or '
          'cuDNN kernel (besides them only PyTorch\'s elementwise copies and '
          'its casts of the float32 weight gradients)')

    # ---- phase 62: the amp steps against the float32 steps, in turns
    steps = {}
    for arch in ('tfgridnet', 'dccrn'):
        with tempfile.TemporaryDirectory() as tmp:
            trainers = {key: make_trainer(device, os.path.join(tmp, key),
                                          arch=arch,
                                          use_amp=key == 'kernel')
                        for key in ('plain', 'kernel')}
            step_ms, step_peak = in_turns(
                {key: (lambda t=t: t[0].train_step(t[1], t[2]))
                 for key, t in trainers.items()}, 2, 1)
            del trainers
        torch.cuda.empty_cache()
        prof = trace_or_none(lambda: profile_train.profile(
            device, steps=2, arch=arch, use_amp=True))
        lstm_ms = idle = None
        if prof is not None:
            lstm_ms = sum(v['ms'] for n, v in prof['kernels_per_step'].items()
                          if 'lstm_' in n or 'sum_partials' in n)
            idle = prof['device_idle_share']
        steps[arch] = {'ms': step_ms, 'peak': step_peak, 'lstm_ms': lstm_ms,
                       'idle': idle}
        torch.cuda.empty_cache()
    out['steps'] = steps

    def step_line(arch):
        st = steps[arch]
        traced_step = ('not traced (the profiler recorded nothing)'
                       if st['lstm_ms'] is None else
                       f'its LSTM kernels {st["lstm_ms"]:.2f} ms a step, '
                       f'device idle {100 * st["idle"]:.1f} %')
        return (f'{arch} bf16 amp {st["ms"]["kernel"]:.2f} ms (peak '
                f'{st["peak"]["kernel"] / 2 ** 20:.0f} MiB) vs float32 '
                f'{st["ms"]["plain"]:.2f} ms (peak '
                f'{st["peak"]["plain"] / 2 ** 20:.0f} MiB), amp step '
                f'{traced_step}')

    phase(62, f'[{card}] train step 16 x 4 s, in turns: '
          f'{step_line("tfgridnet")}; {step_line("dccrn")}')
    return out


def rnn_amp_training(arch, L):
    """Phase 60 (TF-GridNet) or 61 (DCCRN): the default model trained by
    ``train.main`` from its untouched config under bf16 amp on FLAC tars,
    and resumed; checks its parameters, the bf16 launches of its LSTM
    kernels, finite losses and that no bf16 tensor reaches an LSTM twin on
    the card. Returns what the phase prints."""
    from brever_tpu_torch.models import count_params
    n_train, n_val, epochs, val_period = RNN_AMP_TRAIN
    n_params = {'tfgridnet': GRID_PARAMS, 'dccrn': DCCRN_PARAMS}[arch]
    seen = []

    def refuse(plain):
        def run(x, *args):
            if x.device.type == 'cuda' and x.dtype == torch.bfloat16:
                seen.append(plain.__name__)
            return plain(x, *args)
        return run

    saved = L.lstm_scan_reference, L.lstm_scan_bwd_plain
    L.lstm_scan_reference, L.lstm_scan_bwd_plain = (refuse(f) for f in saved)
    counters = [(L.lstm_scan_x, 'launches_bf16'),
                (L.lstm_scan_x_bwd, 'launches_bf16'),
                (L.lstm_scan, 'launches_bf16'),
                (L.lstm_scan_bwd, 'launches_bf16'),
                (L.lstm_scan_x_bwd, 'launches'),
                (L.lstm_scan_bwd, 'launches')]
    with tempfile.TemporaryDirectory() as tmp:
        paths = []
        for split, n_items, seed in (('train', n_train, 60),
                                     ('val', n_val, 61)):
            paths.append(os.path.join(tmp, split))
            write_tone_dataset(paths[-1], n_items, 1.0, seed, ext='.flac')
        model_dir = write_model_dir(os.path.join(tmp, 'model'), arch, *paths)
        with open(os.path.join(CONFIG_DIR, f'{arch}.yaml')) as f:
            if 'use_amp: true' not in f.read():
                raise AssertionError(f'{arch}.yaml no longer sets use_amp')
        try:
            first, second, train_s, launches = train_and_resume(
                lambda n: [model_dir, '--device', 'cuda', '--epochs', str(n),
                           '--val_period', str(val_period)], epochs,
                counters)
        finally:
            L.lstm_scan_reference, L.lstm_scan_bwd_plain = saved
    k3, k4, k5, k6, k4_all, k6_all = launches
    if not first.use_amp or count_params(first.model) != n_params \
            or first.flat.dtype != torch.float32:
        raise AssertionError(f'{arch}: not the default model under amp')
    if arch == 'dccrn' and not all(b.dtype == torch.float32
                                   for b in first.model.buffers()):
        raise AssertionError('DCCRN\'s running statistics left float32')
    # the backward runs in training only, always under amp
    fwd, bwd = (k3, k4) if arch == 'tfgridnet' else (k5, k6)
    if fwd == 0 or bwd == 0 or (k4_all, k6_all) != (k4, k6) or seen:
        raise AssertionError(f'{arch} amp training launched K3/K4/K5/K6 '
                             f'bf16 {launches[:4]} (all backward: K4 '
                             f'{k4_all}, K6 {k6_all}); bf16 twin calls on '
                             f'the card: {seen}')
    # the first run's epochs and the resumed run's
    losses = second.loss_logger.train_loss
    if not np.isfinite(losses).all():
        raise AssertionError(f'{arch} amp training loss {losses}')
    metrics = [m for m in second.loss_logger.metrics if m][-1]
    number = {'tfgridnet': 60, 'dccrn': 61}[arch]
    lstm = ('K3-bf16 {} / K4-bf16 {}'.format(k3, k4) if arch == 'tfgridnet'
            else 'K5-bf16 {} / K6-bf16 {}'.format(k5, k6))
    phase(number, f'train.main from the untouched config/models/{arch}.yaml '
          f'(use_amp: true; {n_params:,} parameters; only --device, '
          f'--epochs {epochs} and --val_period {val_period} given) on FLAC '
          f'tars ({n_train} + {n_val} tone-in-noise items of 1 s) in '
          f'{train_s:.1f} s, resumed to {second.epochs_ran}: train loss '
          + ' -> '.join(f'{v:.4f}' for v in losses)
          + f', val snr {metrics["snr"]:.2f} dB, estoi '
          f'{metrics["estoi"]:.3f}, pesq {metrics["pesq"]:.2f}; {lstm} '
          'launches, no bf16 tensor in an LSTM twin on the card; resumed '
          f'bitwise from last.ckpt to epoch {second.epochs_ran}')
    return {'launches': launches[:4], 'seconds': train_s, 'losses': losses}


# ---------------------------------------------------------------------------
# SGMSE+, IDMSE and MANNER under bf16 amp (K7/K8's and K7-BN/K8-BN's bf16
# route)

#: K7/K8-bf16 and K7-BN/K8-BN-bf16 against their bf16 twin on the card:
#: each tensor's SNR at least this (dB)
NORM_BF16_TWIN_DB = 40.0
#: a float32 output (statistics, the affine's gradients) this close to
#: float64 (dB) passes however close the twin is: both are then at float32
#: rounding (a C = 1 gate's dscale is one number: the kernel's double sum
#: of float32 terms read 140.0 dB, the twin's float32 sum 144.1)
NORM_F32_EXACT_DB = 100.0
#: phase 63's GroupNorm cases past the U-Nets' classes, (shape, groups):
#: odd N, B = 1, G = C, a rank-3 odd length, a slab past a 16-block
#: cluster on the vector grid and off it (odd N); GN_UNALIGNED's x and dy
#: also run one element past an 8-byte boundary
GN_BF16_RAGGED = [((1, 384, 7, 13), 32), ((2, 64, 33, 17), 64),
                  ((3, 96, 1001), 24), ((1, 64, 256, 256), 2),
                  ((2, 64, 255, 257), 2)]
#: the bf16 route's shapes for the launches of one call: K7/K8 on each
#: route of the bf16 plan (one block, a cluster that holds the slab, past
#: it), K7-BN/K8-BN at bench_batchnorm's TRACE_SHAPES
GN_BF16_TRACE_SHAPES = (((4, 256, 16, 32), 32), ((4, 256, 256, 501), 32),
                        ((1, 64, 256, 256), 2))
#: phase 63's timed shapes: SGMSE+'s largest GroupNorm, (shape, groups)
GN_BF16_TIMED = ((4, 256, 256, 501), 32)
#: the default models trained from their untouched configs under amp
#: (phases 64-66), then resumed to one epoch more, where the validation
#: falls: FLAC items (train, val), their seconds, epochs, validation
#: period. MANNER's one-cycle schedule spans the run's steps and has no
#: finite rate over fewer than 4 (optax's as the port's): its config's
#: batches of up to 32 s take 4 items of 4 s in one step an epoch
NORM_AMP_TRAIN = {'sgmsep': (8, 1, 1.0, 1, 2), 'idmse': (8, 1, 1.0, 1, 2),
                  'manner': (4, 1, 4.0, 4, 5)}
#: the amp gradients of one full-width step (2 x 2 s) against float64: the
#: relative error of the whole gradient at most this (a bf16 trunk keeps
#: ~3 significant digits; the float32 plain path's is printed beside)
NORM_AMP_GRAD_REL = 0.1
#: the kernels each bf16 norm call launches, by route
NORM_BF16_KERNELS = {
    'k7': ['gn_fwd_cluster'], 'k8': ['gn_bwd_cluster', 'gn_bwd_channels'],
    'k7bn': ['gn_fwd_cluster'], 'k8bn': ['gn_bwd_cluster'],
    'k8bn_passes': ['bn_bwd_partials', 'bn_bwd_dx']}

NORM_BF16_TRACE = """
import json
import torch
from brever_tpu_torch.bench_batchnorm import TRACE_SHAPES
from brever_tpu_torch.numerics import disable_tf32
from brever_tpu_torch.ops import batchnorm as bn
from brever_tpu_torch.ops import groupnorm as gn
import chip_smoke

disable_tf32()
dev = torch.device('cuda', 0)
gen = torch.Generator(device=dev).manual_seed(63)
bf = torch.bfloat16


def rand(*shape, scale=1.0, center=0.0):
    return (center + scale * torch.randn(*shape, generator=gen, device=dev)
            ).to(bf)


def names(fn):
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(3):
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        got = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        if got:
            break
    return got


out = []
with torch.no_grad():
    for shape, groups in chip_smoke.GN_BF16_TRACE_SHAPES:
        x, dy = rand(*shape), rand(*shape)
        scale, bias = rand(shape[1], scale=0.1, center=1.0), rand(shape[1])
        _, mean, rstd = gn.group_norm_act_fwd(x, scale, bias, groups, 1e-6,
                                              'silu')
        n = x[0, 0].numel()
        out.append({
            'shape': shape, 'route': gn.plan_info(shape[0], shape[1], n,
                                                  groups, 2)['route'],
            'k7': names(lambda: gn.group_norm_act_fwd(
                x, scale, bias, groups, 1e-6, 'silu')),
            'k8': names(lambda: gn.group_norm_act_bwd(
                x, dy, scale, bias, mean, rstd, groups, 'silu'))})
    for shape in TRACE_SHAPES:
        x, dy = rand(*shape), rand(*shape)
        scale, bias = rand(shape[1], scale=0.1, center=1.0), rand(shape[1])
        _, mean, _, rstd = bn.batch_norm_act_fwd(x, scale, bias, 1e-5,
                                                 'relu')
        plan = bn.plan_info(*shape, 2)
        out.append({
            'shape': shape, 'route': plan['route_fwd'],
            'route_bwd': plan['route_bwd'],
            'k7bn': names(lambda: bn.batch_norm_act_fwd(
                x, scale, bias, 1e-5, 'relu')),
            'k8bn': names(lambda: bn.batch_norm_act_bwd(
                x, dy, scale, bias, mean, rstd, 'relu'))})
print(json.dumps(out))
"""


def norm_bf16_trace():
    """Starts tracing one call of each bf16 norm kernel on each route in a
    fresh interpreter (:func:`norm_traced_kernels` waits)."""
    root = os.path.dirname(os.path.abspath(__file__))
    return subprocess.Popen([sys.executable, '-c', NORM_BF16_TRACE],
                            cwd=root, env=dict(os.environ, PYTHONPATH=root),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def norm_traced_kernels(run):
    """The kernels each traced bf16 norm call of ``run`` launched; fails
    unless each launched its route's kernels once each
    (``NORM_BF16_KERNELS``), the templated ones at ``__nv_bfloat16``, and
    besides them
    only PyTorch's elementwise kernels (the wrapper's widening of the bf16
    affine to float32): no cuDNN kernel. Returns ``{key: launches a
    call}``. Stops the process in any case."""
    try:
        stdout, stderr = run.communicate(timeout=600)
    finally:
        run.kill()
    if run.returncode:
        raise AssertionError(f'bf16 norm trace: {stderr[-3000:]}')
    counts = {}
    for case in json.loads(stdout.strip().splitlines()[-1]):
        for key in ('k7', 'k8', 'k7bn', 'k8bn'):
            if key not in case:
                continue
            got = case[key]
            want = NORM_BF16_KERNELS[
                'k8bn_passes' if key == 'k8bn'
                and case['route_bwd'] == 'passes' else key]
            ours = [n for n in got if any(k in n for k in want)]
            other = [n for n in got if n not in ours
                     and 'at::native' not in n]
            # (gn_bwd_channels sums float32 partials: not a template)
            if len(ours) != len(want) or any(
                    sum(k in n for n in ours) != 1 for k in want) \
                    or any('<' in n and 'bfloat16' not in n
                           for n in ours) or other:
                raise AssertionError(f'{key.upper()}-bf16 at {case["shape"]}'
                                     f' ({case["route"]}) launched {got}')
            counts[key] = len(ours)
    return counts


def twin_check(name, got, twin, exact, min_db=NORM_BF16_TWIN_DB):
    """``got`` (a bf16 output, or a float32 statistic or affine gradient)
    against its twin's ``twin`` (the same dtype) and float64 ``exact``, on
    the card: finite, SNR against the twin >= ``min_db`` and no farther
    from float64 than the twin (BF16_F64_SLACK_DB; a float32 output may
    instead be NORM_F32_EXACT_DB from it). Returns (SNR vs twin,
    SNR vs float64, twin's, max abs err vs the twin)."""
    if got.dtype != twin.dtype or got.shape != twin.shape:
        raise AssertionError(f'{name}: {got.dtype} {tuple(got.shape)}, the '
                             f'twin\'s {twin.dtype} {tuple(twin.shape)}')
    dtype = got.dtype
    got, twin, exact = (t.detach().double() for t in (got, twin, exact))
    if not torch.isfinite(got).all():
        raise AssertionError(f'{name}: not finite')

    def db(a, b):
        err = ((a - b) ** 2).sum().clamp_min(1e-300)
        return 10 * math.log10(max((b ** 2).sum().item(), 1e-300)
                               / err.item())

    vs_twin, vs_exact, twin_exact = db(got, twin), db(got, exact), \
        db(twin, exact)
    floor = twin_exact - BF16_F64_SLACK_DB
    if dtype == torch.float32:
        floor = min(floor, NORM_F32_EXACT_DB)
    if vs_twin < min_db or vs_exact < floor:
        raise AssertionError(f'{name}: SNR vs twin {vs_twin:.2f} dB (>= '
                             f'{min_db}), vs float64 {vs_exact:.2f} dB, the '
                             f'twin\'s {twin_exact:.2f} dB')
    return vs_twin, vs_exact, twin_exact, (got - twin).abs().max().item()


def meta_calls(arch):
    """The norm calls of one ``arch`` forward at its reference shape,
    recorded on the meta device (no arithmetic): ``{(shape, groups, silu):
    count}`` of an SGMSE+/IDMSE U-Net evaluation at 4 x 4 s
    (``bench_groupnorm.unet_calls``), ``{(shape, act): count}`` of a MANNER
    train-mode forward at 16 x 4 s (``bench_batchnorm.manner_calls``)."""
    from brever_tpu_torch.models import ModelRegistry, common
    from brever_tpu_torch.models.sgmse import net
    model = ModelRegistry.get(arch)(device='meta')
    if arch == 'manner':
        from brever_tpu_torch.bench_batchnorm import manner_calls
        inner = common.batch_norm_act
        common.batch_norm_act = lambda x, scale, *a, **k: (x, scale, scale)
        try:
            return manner_calls(model, 'meta')
        finally:
            common.batch_norm_act = inner
    from brever_tpu_torch.bench_groupnorm import unet_calls
    inner = net.group_norm_silu
    net.group_norm_silu = lambda x, *a, **k: x
    try:
        return unet_calls(model, 'meta')
    finally:
        net.group_norm_silu = inner


def norm_bf16_phase(device, card):
    """Phase 63: K7-, K8-, K7-BN- and K8-BN-bf16 against their bf16 twins
    and float64 at every GroupNorm class of one ``sgmsep`` and one
    ``idmse`` evaluation at 4 x 4 s (and ragged shapes) and every
    BatchNorm class of a MANNER step at 16 x 4 s (every route of the bf16
    plans), reruns bitwise; their times at the largest shapes against the
    float32 route, the twin and the library in bf16; the launches of a
    call from a trace in a fresh interpreter. Returns what the kernels'
    JSON records read."""
    from brever_tpu_torch.ops import batchnorm as bn
    from brever_tpu_torch.ops import groupnorm as gn
    bf = torch.bfloat16
    tracer = norm_bf16_trace()
    try:
        gen = torch.Generator(device=device).manual_seed(63)

        def rand(*shape, scale=1.0, center=0.0, dtype=bf):
            return (center + scale * torch.randn(*shape, generator=gen,
                                                 device=device)).to(dtype)

        worst = {k: float('inf') for k in ('k7', 'k8', 'k7bn', 'k8bn')}
        err = {k: 0.0 for k in worst}
        gap = -float('inf')
        routes = {'gn': set(), 'bn_fwd': set(), 'bn_bwd': set()}

        def held(key, label, names, gots, twins, exacts):
            nonlocal gap
            for part, got, twin, exact in zip(names, gots, twins, exacts):
                vs_twin, vs_exact, twin_exact, e = twin_check(
                    f'{key.upper()}-bf16 {label} {part}', got, twin, exact)
                worst[key] = min(worst[key], vs_twin)
                err[key] = max(err[key], e)
                gap = max(gap, twin_exact - vs_exact)

        def unaligned(t):
            """``t`` one element past an 8-byte boundary (the 2-byte
            route)."""
            flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=device)
            out = flat[1:].view(t.shape)
            out.copy_(t)
            return out

        gn_cases = {}
        for arch in ('sgmsep', 'idmse'):
            for (shape, groups, silu), _ in meta_calls(arch).items():
                gn_cases[(shape, groups)] = gn_cases.get(
                    (shape, groups), set()) | {silu}
        n_classes = len(gn_cases)
        for shape, groups in GN_BF16_RAGGED:
            gn_cases[(tuple(shape), groups)] = {True}
        gn_cases[(GN_UNALIGNED[0], GN_UNALIGNED[1], 'unaligned')] = {True}
        for key, acts in gn_cases.items():
            shape, groups = key[0], key[1]
            for silu in sorted(acts):
                act = 'silu' if silu else 'none'
                x, dy = rand(*shape, scale=2.0, center=0.3), rand(*shape)
                scale = rand(shape[1], scale=0.1, center=1.0)
                bias = rand(shape[1], scale=0.1)
                if len(key) == 3:
                    x, dy = unaligned(x), unaligned(dy)
                label = (f'{shape} G={groups} {act}'
                         + ' unaligned' * (len(key) == 3))
                n = x[0, 0].numel()
                routes['gn'].add(gn.plan_info(shape[0], shape[1], n, groups,
                                              2)['route'])
                with torch.no_grad():
                    y, mean, rstd = gn.group_norm_act_fwd(x, scale, bias,
                                                          groups, 1e-6, act)
                    again = gn.group_norm_act_fwd(x, scale, bias, groups,
                                                  1e-6, act)
                    if not all(torch.equal(a, b) for a, b in zip(
                            (y, mean, rstd), again)):
                        raise AssertionError(f'K7-bf16 {label}: two runs '
                                             'differ')
                    twin = gn.group_norm_act_reference(x, scale, bias,
                                                       groups, 1e-6, act)
                    wide = [t.double() for t in (x, scale, bias)]
                    exact = gn.group_norm_act_reference(*wide, groups, 1e-6,
                                                        act)
                    held('k7', label, ('y', 'mean', 'rstd'),
                         (y, mean, rstd), twin, exact)
                    grads = gn.group_norm_act_bwd(x, dy, scale, bias, mean,
                                                  rstd, groups, act)
                    again = gn.group_norm_act_bwd(x, dy, scale, bias, mean,
                                                  rstd, groups, act)
                    if not all(torch.equal(a, b)
                               for a, b in zip(grads, again)):
                        raise AssertionError(f'K8-bf16 {label}: two runs '
                                             'differ')
                    twin_g = gn.group_norm_act_bwd_plain(
                        x, dy, scale, bias, *twin[1:], groups, act)
                    exact_g = gn.group_norm_act_bwd_plain(
                        wide[0], dy.double(), *wide[1:], *exact[1:], groups,
                        act)
                    held('k8', label, ('dx', 'dscale', 'dbias'), grads,
                         twin_g, exact_g)
                del x, dy, y, mean, rstd, again, twin, wide, exact, grads
                del twin_g, exact_g
        torch.cuda.empty_cache()
        bn_cases = dict.fromkeys(meta_calls('manner'))
        n_bn_classes = len(bn_cases)
        for shape in BN_CASES:
            bn_cases[(shape, 'relu')] = None
        for shape, act in bn_cases:
            x, dy = rand(*shape, scale=2.0, center=0.5), rand(*shape)
            scale = rand(shape[1], scale=0.1, center=1.0)
            bias = rand(shape[1], scale=0.1)
            label = f'{shape} {act}'
            plan = bn.plan_info(*shape, 2)
            routes['bn_fwd'].add(plan['route_fwd'])
            routes['bn_bwd'].add(plan['route_bwd'])
            with torch.no_grad():
                out = bn.batch_norm_act_fwd(x, scale, bias, 1e-5, act)
                again = bn.batch_norm_act_fwd(x, scale, bias, 1e-5, act)
                if not all(torch.equal(a, b) for a, b in zip(out, again)):
                    raise AssertionError(f'K7-BN-bf16 {label}: two runs '
                                         'differ')
                twin = bn.batch_norm_act_reference(x, scale, bias, 1e-5, act)
                wide = [t.double() for t in (x, scale, bias)]
                exact = bn.batch_norm_act_reference(*wide, 1e-5, act)
                held('k7bn', label, ('y', 'mean', 'var', 'rstd'), out, twin,
                     exact)
                y, mean, var, rstd = out
                grads = bn.batch_norm_act_bwd(x, dy, scale, bias, mean, rstd,
                                              act)
                again = bn.batch_norm_act_bwd(x, dy, scale, bias, mean, rstd,
                                              act)
                if not all(torch.equal(a, b) for a, b in zip(grads, again)):
                    raise AssertionError(f'K8-BN-bf16 {label}: two runs '
                                         'differ')
                twin_g = bn.batch_norm_act_bwd_plain(
                    x, dy, scale, bias, twin[1], twin[3], act)
                exact_g = bn.batch_norm_act_bwd_plain(
                    wide[0], dy.double(), *wide[1:], exact[1], exact[3], act)
                held('k8bn', label, ('dx', 'dscale', 'dbias'), grads, twin_g,
                     exact_g)
            del x, dy, out, again, twin, wide, exact, grads, twin_g, exact_g
        torch.cuda.empty_cache()

        # times at the largest shapes: the bf16 route, the float32 route,
        # the bf16 twin and the library in bf16, in turns
        import torch.nn.functional as F
        timing = {}
        for key, shape, groups, act in (
                ('gn', *GN_BF16_TIMED, 'silu'), ('bn', BN_CASES[0], None,
                                                 'relu')):
            x32 = rand(*shape, scale=2.0, center=0.3, dtype=torch.float32)
            dy32 = rand(*shape, dtype=torch.float32)
            s32 = rand(shape[1], scale=0.1, center=1.0, dtype=torch.float32)
            b32 = rand(shape[1], scale=0.1, dtype=torch.float32)
            x, dy, scale, bias = (t.to(bf) for t in (x32, dy32, s32, b32))
            if key == 'gn':
                def fwd(x, s, b, plain=False):
                    f = gn.group_norm_act_reference if plain \
                        else gn.group_norm_act_fwd
                    return f(x, s, b, groups, 1e-6, act)

                def bwd(x, dy, s, b, st, plain=False):
                    f = gn.group_norm_act_bwd_plain if plain \
                        else gn.group_norm_act_bwd
                    return f(x, dy, s, b, *st, groups, act)

                def lib(x, s, b):
                    return F.silu(F.group_norm(x, groups, s, b, 1e-6))
                stats = lambda out: out[1:]   # noqa: E731
            else:
                def fwd(x, s, b, plain=False):
                    f = bn.batch_norm_act_reference if plain \
                        else bn.batch_norm_act_fwd
                    return f(x, s, b, 1e-5, act)

                def bwd(x, dy, s, b, st, plain=False):
                    f = bn.batch_norm_act_bwd_plain if plain \
                        else bn.batch_norm_act_bwd
                    return f(x, dy, s, b, *st, act)

                def lib(x, s, b):
                    return F.relu(F.batch_norm(x, None, None, s, b, True,
                                               0.0, 1e-5))
                stats = lambda out: (out[1], out[3])   # noqa: E731
            with torch.no_grad():
                st, st32 = stats(fwd(x, scale, bias)), \
                    stats(fwd(x32, s32, b32))
                fwd_ms = in_turns({
                    'kernel': lambda: fwd(x, scale, bias),
                    'plain': lambda: fwd(x, scale, bias, True)}, 5, 2)[0]
                fwd_ms['f32'] = cuda_ms(lambda: fwd(x32, s32, b32), 5, 2)
                fwd_ms['library'] = cuda_ms(lambda: lib(x, scale, bias), 5,
                                            2)
                bwd_ms = in_turns({
                    'kernel': lambda: bwd(x, dy, scale, bias, st),
                    'plain': lambda: bwd(x, dy, scale, bias, st, True)},
                    5, 2)[0]
                bwd_ms['f32'] = cuda_ms(
                    lambda: bwd(x32, dy32, s32, b32, st32), 5, 2)
            xl, sl, bl = (t.clone().requires_grad_() for t in (x, scale,
                                                              bias))
            yl = lib(xl, sl, bl)
            bwd_ms['library'] = cuda_ms(lambda: torch.autograd.grad(
                yl, (xl, sl, bl), dy, retain_graph=True), 5, 2)
            n = x.numel()
            timing[key] = {
                'fwd': fwd_ms, 'bwd': bwd_ms, 'shape': list(shape),
                'bound': (bound(10 * n, 2 * 2 * n, BF16_FLOPS),
                          bound(20 * n, 2 * 3 * n, BF16_FLOPS))}
            del x32, dy32, x, dy, xl, yl, st, st32
            torch.cuda.empty_cache()
        # K8-BN-bf16 on both routes at the largest shape (its plan takes
        # the passes where only a 16-block cluster holds the channel)
        from brever_tpu_torch.bench_batchnorm import time_bwd_routes
        timing['bn']['bwd_routes'] = time_bwd_routes(BN_CASES[0], 'relu',
                                                     device, dtype=bf)
    except BaseException:
        tracer.kill()
        raise
    launches = norm_traced_kernels(tracer)
    g, b = timing['gn'], timing['bn']

    def times(t, d):
        return (f'{t[d]["kernel"]:.3f}/{t[d]["f32"]:.3f}/{t[d]["plain"]:.3f}'
                f'/{t[d]["library"]:.3f}')

    phase(63, f'K7/K8-bf16 at {n_classes} GroupNorm classes of an sgmsep and '
          f'an idmse evaluation at 4 x 4 s, {len(GN_BF16_RAGGED)} ragged and '
          f'one unaligned (routes {sorted(routes["gn"])}); K7-BN/K8-BN-bf16 '
          f'at {n_bn_classes} MANNER classes at 16 x 4 s and {BN_CASES} '
          f'(routes {sorted(routes["bn_fwd"])}/{sorted(routes["bn_bwd"])}): '
          f'every output and gradient agrees with the bf16 twin on the card '
          f'(worst SNR K7 {worst["k7"]:.1f}, K8 {worst["k8"]:.1f}, K7-BN '
          f'{worst["k7bn"]:.1f}, K8-BN {worst["k8bn"]:.1f} dB >= '
          f'{NORM_BF16_TWIN_DB}) and is no farther from float64 than the '
          f'twin (at most {gap:.2f} dB under it, <= {BF16_F64_SLACK_DB}); '
          f'two runs bitwise equal; a call launches only its own kernels at '
          f'__nv_bfloat16 ({launches}), no cuDNN (fresh-interpreter trace); '
          f'[{card}] bf16/f32/twin/library-bf16 ms: K7 {GN_BF16_TIMED[0]} '
          f'{times(g, "fwd")} K8 {times(g, "bwd")}; K7-BN {BN_CASES[0]} '
          f'{times(b, "fwd")} K8-BN {times(b, "bwd")} (card ms by route: '
          + ', '.join(f'{k} {v:.3f}' for k, v in b['bwd_routes'].items())
          + ')')
    return {'worst_db': worst, 'err': err, 'timing': timing,
            'launches_a_call': launches}


#: the amp gradients of one full-width step against float64 (phases
#: 64-66): the whole gradient's SNR at most this many dB under that of the
#: same amp step through the norms' bf16 twins (both bf16 trunks; the
#: float32 plain path's SNR is printed beside)
NORM_AMP_SLACK_DB = 3.0
#: the amp loss of that step within this relative error of float64's
NORM_AMP_LOSS_REL = 2e-2
#: phase 67's steps: (arch, batch of 4 s items)
NORM_AMP_STEPS = (('sgmsep', 4), ('idmse', 4), ('manner', 16))
#: the keys that take one amp step each in phase 65: IDMSE-large, and the
#: lighter U-Net under the EDM preconditioning and the cosine SDE (the
#: other two SGMSE+ keys run these nets and those rules)
NORM_AMP_ONE_STEP = ('idmselarge', 'sgmsepmheun')


NORM_AMP_STEPS_RUN = """
import json
import tempfile
import torch
import chip_smoke
from brever_tpu_torch.numerics import disable_tf32
from brever_tpu_torch.profile_enhance import _device_time
from brever_tpu_torch.profile_train import NORM_KERNELS, make_trainer

disable_tf32()
device = torch.device('cuda', 0)
out = {}
for arch, batch in chip_smoke.NORM_AMP_STEPS:
    with tempfile.TemporaryDirectory() as tmp:
        trainers = {key: make_trainer(device, f'{tmp}/{key}', arch=arch,
                                      batch=batch, use_amp=key == 'kernel')
                    for key in ('plain', 'kernel')}
        steps = {key: (lambda t=t: t[0].train_step(t[1], t[2]))
                 for key, t in trainers.items()}
        ms, peak = chip_smoke.in_turns(steps, 1, None)
        del trainers['plain']
        torch.cuda.empty_cache()

        def traced():
            acts = [torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts) as prof:
                step_ms = chip_smoke.cuda_ms(steps['kernel'], 1, 0)
            busy_us, kernels = _device_time(prof)
            return {'norm_ms': sum(us for name, (us, _) in kernels.items()
                                   if any(k in name for k in NORM_KERNELS))
                    / 1e3,
                    'idle': 1 - busy_us / 1e3 / step_ms}

        prof = chip_smoke.trace_or_none(traced) or {'norm_ms': None,
                                                    'idle': None}
        out[arch] = {'ms': ms, 'peak': peak, 'batch': batch, **prof}
        del trainers, steps
    torch.cuda.empty_cache()
print(json.dumps(out))
"""


def norm_amp_steps():
    """Phase 67 in a fresh interpreter (the profiler loses device events
    after several traces in one process): each arch's amp train step
    against its float32 step in turns at ``NORM_AMP_STEPS``, peak memory,
    and one traced amp step's norm kernels (ms) and idle share: ``{arch:
    {ms, peak, batch, norm_ms, idle}}``."""
    root = os.path.dirname(os.path.abspath(__file__))
    run = subprocess.run([sys.executable, '-c', NORM_AMP_STEPS_RUN],
                         cwd=root, env=dict(os.environ, PYTHONPATH=root),
                         capture_output=True, text=True, timeout=900)
    if run.returncode:
        raise AssertionError(f'amp steps: {run.stderr[-3000:]}')
    return json.loads(run.stdout.strip().splitlines()[-1])


def norm_counters():
    """The launch counters of the norm kernels: K7, K8, K7-BN, K8-BN, each
    all launches and the bf16 route's."""
    from brever_tpu_torch.ops import batchnorm as bn
    from brever_tpu_torch.ops import groupnorm as gn
    return [(f, attr) for f in (gn.group_norm_act_fwd, gn.group_norm_act_bwd,
                                bn.batch_norm_act_fwd, bn.batch_norm_act_bwd)
            for attr in ('launches_bf16', 'launches')]


@contextlib.contextmanager
def twins_refused_in_bf16():
    """Records every call of a norm's plain forward or backward with a
    bf16 tensor on the card (the bf16 route must launch its kernel there);
    yields the list of such calls."""
    from brever_tpu_torch.ops import batchnorm as bn
    from brever_tpu_torch.ops import groupnorm as gn
    seen = []
    names = [(gn, 'group_norm_act_reference'),
             (gn, 'group_norm_act_bwd_plain'),
             (bn, 'batch_norm_act_reference'),
             (bn, 'batch_norm_act_bwd_plain')]
    saved = [getattr(mod, name) for mod, name in names]

    def watch(plain):
        def run(x, *args):
            if x.device.type == 'cuda' and x.dtype == torch.bfloat16:
                seen.append(plain.__name__)
            return plain(x, *args)
        return run

    for (mod, name), plain in zip(names, saved):
        setattr(mod, name, watch(plain))
    try:
        yield seen
    finally:
        for (mod, name), plain in zip(names, saved):
            setattr(mod, name, plain)


def amp_step_grads(trainer, batch, lengths, draws, plain=False):
    """The amp step's loss and master gradients (numpy float64, by name),
    as ``train_step`` forms them without the update, t and the noise fixed
    for SGMSE+/IDMSE (``draws``); with ``plain`` the norms take their bf16
    twins on the card."""
    from brever_tpu_torch.models.base import sample_weighted_mean
    model = trainer.model
    model.train()
    ctx = (plain_batchnorms() if plain and draws is None else
           plain_groupnorms() if plain else contextlib.nullcontext())
    with ctx, trainer._amp_params():
        b = trainer._amp_batch(batch)
        if draws is None:
            items = model.loss(b, lengths)
        else:
            items = model.loss_at(b, lengths, *draws)
        loss = sample_weighted_mean(items, lengths)
        grads = torch.autograd.grad(loss, trainer._param_list)
    model.eval()
    return float(loss), {k: g.double().cpu().numpy() for (k, _), g in
                         zip(model.named_parameters(), grads)}


def reference_grads(trainer, batch, lengths, draws, dtype):
    """The same step's loss and gradients of a copy of the model in
    ``dtype`` (float64, or float32) on the bf16-rounded parameters and
    batch, the norms on their plain versions."""
    from brever_tpu_torch.models.base import sample_weighted_mean
    model = copy.deepcopy(trainer.model)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(p.bfloat16())
    model = model.to(dtype).train()
    ctx = plain_batchnorms() if draws is None else plain_groupnorms()
    with ctx:
        b = batch.bfloat16().to(dtype)
        if draws is None:
            items = model.loss(b, lengths)
        else:
            cdtype = torch.complex128 if dtype == torch.float64 \
                else torch.complex64
            items = model.loss_at(b, lengths, draws[0].to(dtype),
                                  draws[1].to(cdtype))
        loss = sample_weighted_mean(items, lengths)
        grads = torch.autograd.grad(loss, list(model.parameters()))
    out = {k: g.double().cpu().numpy()
           for (k, _), g in zip(model.named_parameters(), grads)}
    del model, grads
    torch.cuda.empty_cache()
    return float(loss), out


def norm_amp_training(arch, number):
    """Phase 64 (sgmsep), 65 (idmse) or 66 (manner): the default model
    trained by ``train.main`` from its untouched config under bf16 amp on
    FLAC tars and resumed bitwise (``train_and_resume``); checks its
    parameters, the bf16 launches of its norm kernels (every backward one
    bf16), finite losses and that no bf16 tensor reaches a norm twin on the
    card. Returns what the phase prints."""
    from brever_tpu_torch.models import count_params
    n_train, n_val, seconds, epochs, val_period = NORM_AMP_TRAIN[arch]
    n_params = {'sgmsep': SGMSE_PARAMS, 'idmse': IDMSE_PARAMS['idmse'],
                'manner': MANNER_PARAMS}[arch]
    with tempfile.TemporaryDirectory() as tmp, \
            twins_refused_in_bf16() as seen:
        paths = []
        for split, n_items, seed in (('train', n_train, number),
                                     ('val', n_val, number + 100)):
            paths.append(os.path.join(tmp, split))
            write_tone_dataset(paths[-1], n_items, seconds, seed,
                               ext='.flac')
        model_dir = write_model_dir(os.path.join(tmp, 'model'), arch, *paths)
        with open(os.path.join(CONFIG_DIR, f'{arch}.yaml')) as f:
            if 'use_amp: true' not in f.read():
                raise AssertionError(f'{arch}.yaml no longer sets use_amp')
        first, second, train_s, launches = train_and_resume(
            lambda n: [model_dir, '--device', 'cuda', '--epochs', str(n),
                       '--val_period', str(val_period)], epochs,
            norm_counters(), more=1)
    k7b, k7, k8b, k8, k7bnb, k7bn, k8bnb, k8bn = launches
    if not first.use_amp or count_params(first.model) != n_params \
            or first.flat.dtype != torch.float32 \
            or not all(b.dtype == torch.float32
                       for b in first.model.buffers()):
        raise AssertionError(f'{arch}: not the default model under amp')
    fwd, bwd, bwd_all = ((k7bnb, k8bnb, k8bn) if arch == 'manner'
                         else (k7b, k8b, k8))
    if fwd == 0 or bwd == 0 or bwd != bwd_all or seen:
        raise AssertionError(f'{arch} amp training launched {launches} '
                             f'(bf16, all: K7, K8, K7-BN, K8-BN); bf16 twin'
                             f' calls on the card: {sorted(set(seen))}')
    losses = second.loss_logger.train_loss
    if not np.isfinite(losses).all():
        raise AssertionError(f'{arch} amp training loss {losses}')
    metrics = [m for m in second.loss_logger.metrics if m][-1]
    kernels = (f'K7-BN-bf16 {k7bnb} / K8-BN-bf16 {k8bnb}' if arch == 'manner'
               else f'K7-bf16 {k7b} / K8-bf16 {k8b}')
    return {'launches': launches, 'seconds': train_s, 'losses': losses,
            'metrics': metrics, 'kernels': kernels,
            'resumed_to': second.epochs_ran, 'n_params': n_params,
            'data': f'{n_train} + {n_val} items of {seconds:g} s',
            'epochs': epochs, 'val_period': val_period}


def norm_amp_phases(device, card):
    """Phases 64-67: SGMSE+, IDMSE (and IDMSE-large, the other SGMSE+ keys)
    and MANNER under bf16 amp: one full-width step's loss and gradients
    against float64, the same step through the norms' bf16 twins and the
    float32 plain path; ``train.main`` from each untouched config on FLAC,
    resumed bitwise; one amp enhance; then the amp steps against float32 in
    turns, their peak memory, the bf16 norm kernels' device time a step and
    the idle share. Returns what the kernels' JSON records read."""
    from brever_tpu_torch.profile_train import make_trainer
    out = {'train': {}, 'steps': {}}
    for number, arch in ((64, 'sgmsep'), (65, 'idmse'), (66, 'manner')):
        # ---- one full-width step at 1 x 1 s against float64
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            trainer, batch, lengths = make_trainer(
                device, tmp, seed=number, batch=1, seconds=1.0, arch=arch,
                use_amp=True)
            draws = None
            if arch != 'manner':
                rng = np.random.RandomState(number)
                grid = trainer.model.transform(batch).shape[2:]
                draws = (torch.full((1, 1, 1, 1), 0.6, device=device),
                         complex_input(rng, (1, 1, *grid), device, 1.0))
            for f, attr in norm_counters():
                setattr(f, attr, 0)
            loss, got = amp_step_grads(trainer, batch, lengths, draws)
            bf16_bwd = norm_counters()[2 if arch != 'manner' else 6]
            launched = getattr(*bf16_bwd)
            _, twin = amp_step_grads(trainer, batch, lengths, draws, True)
            ref_loss, ref = reference_grads(trainer, batch, lengths, draws,
                                            torch.float64)
            _, f32 = reference_grads(trainer, batch, lengths, draws,
                                     torch.float32)
            # ---- one amp enhance (the float32 one beside it)
            x = batch[:1, 0]
            gen = torch.Generator(device=device)

            def enhance():   # SGMSE+'s solver noise from one seed
                if draws is None:
                    return trainer.model.enhance(x)
                return trainer.model.enhance(x, generator=gen.manual_seed(0))

            with torch.no_grad():
                trainer.model.eval()
                with trainer._amp_params():
                    amp_out = enhance()
            del trainer, batch
            torch.cuda.empty_cache()
        step_s = time.perf_counter() - t0
        k = grad_report(ref, got)
        t = grad_report(ref, twin)
        p = grad_report(ref, f32)
        del got, twin, ref, f32
        loss_rel = abs(loss - ref_loss) / abs(ref_loss)
        enh_ok = (amp_out.dtype == torch.float32
                  and amp_out.shape == (1, FS)
                  and bool(torch.isfinite(amp_out).all()))
        if not launched or k[0] < t[0] - NORM_AMP_SLACK_DB \
                or loss_rel > NORM_AMP_LOSS_REL or not enh_ok \
                or not np.isfinite(k[0]):
            raise AssertionError(
                f'{arch} amp step: {launched} bf16 backward launches, '
                f'gradient SNR vs float64 {k[0]:.2f} dB (twins {t[0]:.2f}), '
                f'loss {loss} vs {ref_loss}, enhance {amp_out.dtype} '
                f'{tuple(amp_out.shape)}')
        train = norm_amp_training(arch, number)
        extra = ''
        if arch == 'idmse':
            # the other keys of the families: one amp step each
            steps = []
            for key in NORM_AMP_ONE_STEP:
                with tempfile.TemporaryDirectory() as tmp:
                    tr, b, n = make_trainer(device, tmp, batch=1,
                                            seconds=1.0, arch=key,
                                            use_amp=True)
                    step_loss = float(tr.train_step(b, n))
                    del tr, b
                torch.cuda.empty_cache()
                if not np.isfinite(step_loss):
                    raise AssertionError(f'{key} amp step loss {step_loss}')
                steps.append(f'{key} {step_loss:.4f}')
            extra = '; one amp step each (1 x 1 s): ' + ', '.join(steps)
        out['train'][arch] = dict(train, grad_db=k[0], twin_db=t[0],
                                  f32_db=p[0], loss_rel=loss_rel,
                                  step_s=step_s)
        phase(number, f'{arch} ({train["n_params"]:,} parameters) under bf16 '
              f'amp: one step at 1 x 1 s (t and noise fixed) vs float64 on '
              f'the bf16-rounded weights: whole gradient {k[0]:.1f} dB '
              f'(worst tensor {k[1]:.1f} dB, {k[2]}), the same amp step '
              f'through the norms\' bf16 twins {t[0]:.1f} dB (>= it less '
              f'{NORM_AMP_SLACK_DB}), the float32 plain path {p[0]:.1f} dB; '
              f'loss {loss:.5f} vs float64 {ref_loss:.5f} (rel '
              f'{loss_rel:.1e} <= {NORM_AMP_LOSS_REL}); {launched} bf16 '
              f'backward launches. train.main from the untouched '
              f'config/models/{arch}.yaml (use_amp: true; only --device, '
              f'--epochs {train["epochs"]} and --val_period '
              f'{train["val_period"]} given) on FLAC tars ({train["data"]}) '
              f'in {train["seconds"]:.1f} s:'
              f' train loss ' + ' -> '.join(f'{v:.4f}' for v in
                                             train['losses'])
              + f', val snr {train["metrics"]["snr"]:.2f} dB; '
              f'{train["kernels"]} launches, every backward on the bf16 route,'
              f' no bf16 tensor in a norm twin on the card; resumed bitwise '
              f'from last.ckpt to epoch {train["resumed_to"]}; one amp '
              f'enhance (1 x 1 s) finite float32 of the mixture\'s length '
              f'(the step, its references and the enhance {step_s:.1f} s)'
              f'{extra}')

    # ---- phase 67: the amp steps against the float32 steps, in turns
    torch.cuda.empty_cache()
    steps = out['steps'] = norm_amp_steps()

    def step_line(arch):
        st = steps[arch]
        traced = ('not traced (the profiler recorded nothing)'
                  if st['norm_ms'] is None else
                  f'its bf16 norm kernels {st["norm_ms"]:.2f} ms a step, '
                  f'device idle {100 * st["idle"]:.1f} %')
        return (f'{arch} {st["batch"]} x 4 s bf16 amp '
                f'{st["ms"]["kernel"]:.2f} ms (peak '
                f'{st["peak"]["kernel"] / 2 ** 20:.0f} MiB) vs float32 '
                f'{st["ms"]["plain"]:.2f} ms (peak '
                f'{st["peak"]["plain"] / 2 ** 20:.0f} MiB), amp step '
                f'{traced}')

    phase(67, f'[{card}] train steps, in turns: '
          + '; '.join(step_line(a) for a, _ in NORM_AMP_STEPS))
    return out


def norm_bf16_records(nbf, namp):
    """The ``kernels`` line's records of K7-, K8-, K7-BN- and K8-BN-bf16:
    phase 63's errors and times at the largest shapes, the launches of
    phases 64-66's amp ``train.main`` runs (SGMSE+ and IDMSE for K7/K8,
    MANNER for K7-BN/K8-BN)."""
    train, timing = namp['train'], nbf['timing']
    gn_runs = [train[a]['launches'] for a in ('sgmsep', 'idmse')]
    bn_run = train['manner']['launches']
    records = []
    for name, key, which, launches, pallas, shape, lib in (
            ('group_norm_act_fwd_bf16', 'k7', ('gn', 'fwd'),
             sum(r[0] for r in gn_runs), 134,
             'B=4 C=256 F=256 T=501 G=32 SiLU bf16', 'F.group_norm + '
             'F.silu in bf16'),
            ('group_norm_act_bwd_bf16', 'k8', ('gn', 'bwd'),
             sum(r[2] for r in gn_runs), 263,
             'B=4 C=256 F=256 T=501 G=32 SiLU bf16', 'the backward of '
             'F.group_norm + F.silu in bf16 (data, scale and bias)'),
            ('bn_act_fwd_bf16', 'k7bn', ('bn', 'fwd'), bn_run[4], 134,
             'B=16 C=60 T=64084 ReLU bf16 (MANNER in_bn at 16 x 4 s)',
             'F.batch_norm(training=True) + F.relu in bf16'),
            ('bn_act_bwd_bf16', 'k8bn', ('bn', 'bwd'), bn_run[6], 263,
             'B=16 C=60 T=64084 ReLU bf16 (MANNER in_bn at 16 x 4 s)',
             'the backward of F.batch_norm(training=True) + F.relu in '
             'bf16')):
        t = timing[which[0]]
        d = t[which[1]]
        b = t['bound'][0 if which[1] == 'fwd' else 1]
        records.append({
            'name': name, 'route': 'cuda',
            'source': 'brever_tpu_torch/csrc/groupnorm_bf16.cu',
            'replaces': f'brever_tpu/ops/pallas/groupnorm.py:{pallas}',
            'launches': launches, 'max_abs_err': nbf['err'][key],
            'ms': d['kernel'], 'plain_ms': d['plain'], 'bound_ms': b[0],
            'bound_by': b[1], 'library_ms': d['library'],
            'library_note': lib, 'shape': shape, 'f32_route_ms': d['f32'],
            'worst_snr_vs_twin_db': nbf['worst_db'][key],
            **({'card_ms_by_route': t['bwd_routes']} if key == 'k8bn'
               else {}),
            'launches_a_call': nbf['launches_a_call'].get(key)})
    return records


def main():
    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke: torch.cuda.is_available() is False; '
                         'this script needs a CUDA device')
    from brever_tpu_torch.checkpoint import load_checkpoint
    from brever_tpu_torch.models import count_params
    from brever_tpu_torch.models.base import sample_weighted_mean
    import brever_tpu_torch.models.convtasnet as convtasnet
    from brever_tpu_torch.numerics import disable_tf32
    from brever_tpu_torch.ops import build
    from brever_tpu_torch.ops import tcn_block as tcn
    from brever_tpu_torch.profile_train import make_trainer
    from brever_tpu_torch.serve import EnhanceService, build_model

    # ---- phase 0: the card and the installation
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        check=True, capture_output=True, text=True).stdout.strip()
    card = smi.splitlines()[0]
    print(smi, flush=True)
    nvcc = subprocess.run([build.find_nvcc(), '--version'], check=True,
                          capture_output=True, text=True).stdout
    optional = []
    for name in ('yaml', 'msgpack', 'h5py'):
        try:
            __import__(name)
            optional.append(f'{name} importable')
        except ImportError:
            optional.append(f'{name} missing')
    disable_tf32()
    phase(0, f'{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}'
          f' | python {platform.python_version()} torch {torch.__version__}'
          f' cuda {torch.version.cuda} nvcc '
          f'{nvcc.strip().splitlines()[-1]} | {", ".join(optional)} | '
          'TF32 off (cudnn, cuda.matmul)')
    device = torch.device('cuda', 0)

    # ---- phase 1: build the kernels from the checkout's sources
    t0 = time.perf_counter()
    path = build.build()
    build.load_library()
    phase(1, f'built {len(build.sources())} source(s) into {path} in '
          f'{time.perf_counter() - t0:.1f} s')

    # ---- phase 2: kernel vs plain version on the card
    rng = np.random.RandomState(0)
    cases = [(4, 3999, 2 ** i, last)
             for i in range(8) for last in (False, True)]
    cases += [(4, 49, 64, False), (4, 49, 128, True), (2, 520, 600, False)]
    # widths that leave partial 128 x 128 tiles and widths off the float4
    # grid (K1's single-float GEMMs): (B, T, d, last, C, H, Cs)
    k1_widths = [(2, 300, 1, False, 36, 100, 20),
                 (2, 129, 128, True, 32, 64, 32),
                 (2, 300, 128, False, 36, 102, 20),
                 (2, 77, 1, True, 130, 257, 21)]
    max_err = 0.0
    with torch.inference_mode():
        for batch, t_total, dilation, last, *widths in \
                [case + (128, 512, 128) for case in cases] + k1_widths:
            c, h, cs = widths
            x, params = block_inputs(rng, batch, t_total, c=c, h=h, cs=cs)
            res, skip = tcn.tcn_block(x, params, dilation, last)
            again = tcn.tcn_block(x, params, dilation, last)
            ref_res, ref_skip = tcn.tcn_block_plain(x, params, dilation,
                                                    last)
            torch.cuda.synchronize()
            pairs = [(skip, ref_skip, again[1])] + (
                [] if last else [(res, ref_res, again[0])])
            if last and res is not None:
                raise AssertionError('last block returned a residual')
            for got, want, rerun in pairs:
                torch.testing.assert_close(got, want, atol=KERNEL_ATOL,
                                           rtol=KERNEL_RTOL)
                max_err = max(max_err, (got - want).abs().max().item())
                if not torch.equal(got, rerun):
                    raise AssertionError(f'K1 B={batch} T={t_total} C/H/Cs '
                                         f'{widths}: two runs differ')
    phase(2, f'{len(cases)} block cases (T 3999 d 1..128 last both ways, '
          f'T 49 d 64/128, T 520 d 600) and {len(k1_widths)} at C/H/Cs '
          + ', '.join('{}/{}/{}'.format(*w[4:]) for w in k1_widths)
          + f' agree with the plain version: max abs err {max_err:.3e} '
          f'(atol {KERNEL_ATOL}, rtol {KERNEL_RTOL}: f32 both, other '
          'summation order over ~2M elements a row); two runs bitwise equal')

    # ---- phase 3: the full model on the card vs the plain CPU path
    flax_params = random_flax_params(np.random.RandomState(1), **DEFAULT)
    with tempfile.TemporaryDirectory() as tmp:
        model_dir = write_model_dir(os.path.join(tmp, 'model'), 'convtasnet',
                                    params=flax_params)
        gpu = EnhanceService(model_dir, device)
        cpu = EnhanceService(model_dir, 'cpu')
    if count_params(gpu.model) != N_PARAMS:
        raise AssertionError(f'{count_params(gpu.model)} parameters')
    mix = (0.1 * np.random.RandomState(2).randn(4, 2, 4 * FS)) \
        .astype(np.float32)
    tcn.tcn_block.launches = 0
    out = gpu.model.enhance(mix)
    torch.cuda.synchronize()
    launches_model = tcn.tcn_block.launches
    ref = cpu.model.enhance(mix).numpy()
    snr, err = check_output('enhance (4, 2, 64000)', ref, out.cpu().numpy())
    if launches_model != 24:
        raise AssertionError(f'{launches_model} kernel launches, not 24')
    phase(3, f'enhance (4, 2, 64000) on the card: SNR {snr:.2f} dB, max '
          f'abs err {err:.3e} vs CPU plain; {launches_model} block launches')

    # ---- phase 4: the HTTP service on the card
    results = []
    with http_service(gpu) as (port, health):
        if health['params'] != N_PARAMS or health['device'] != str(device):
            raise AssertionError(f'/health: {health}')
        for seconds in (0.05, 4, 10):
            audio = (0.1 * np.random.RandomState(3).randn(
                int(seconds * FS))).astype(np.float32)
            before = tcn.tcn_block.launches
            got = post_wav(port, audio)
            launched = tcn.tcn_block.launches - before
            want = cpu.enhance(audio)
            snr, err = check_output(f'/enhance {seconds} s', want, got)
            if launched != 24:
                raise AssertionError(f'/enhance {seconds} s: {launched} '
                                     'block launches, not 24')
            results.append(f'{seconds} s {snr:.1f} dB')
    launches = tcn.tcn_block.launches
    phase(4, f'/health ok, /enhance {", ".join(results)} vs CPU plain; '
          f'{launches} block launches in phases 3-4')

    # ---- phase 5: timings (plain, kernel, kernel, plain in turns)
    timing = {}
    with torch.inference_mode():
        for dilation in (1, 128):
            x, params = block_inputs(np.random.RandomState(4), 16, 3999)
            runs = {'plain': [], 'kernel': []}
            for name in ('plain', 'kernel', 'kernel', 'plain'):
                fn = tcn.tcn_block_plain if name == 'plain' \
                    else tcn.tcn_block
                runs[name].append(cuda_ms(
                    lambda: fn(x, params, dilation, False), 10))
            timing[dilation] = {k: sum(v) / len(v) for k, v in runs.items()}
        batch = torch.from_numpy((0.1 * np.random.RandomState(5).randn(
            16, 2, 4 * FS)).astype(np.float32)).to(device)
        runs = {'plain': [], 'kernel': []}
        for name in ('plain', 'kernel', 'kernel', 'plain'):
            convtasnet.tcn_block = tcn.tcn_block_plain \
                if name == 'plain' else tcn.tcn_block
            torch.cuda.reset_peak_memory_stats()
            runs[name].append(cuda_ms(lambda: gpu.model.enhance(batch), 5,
                                      warmup=1))
            if name == 'kernel':
                peak = torch.cuda.max_memory_allocated()
        convtasnet.tcn_block = tcn.tcn_block
        model_ms = {k: sum(v) / len(v) for k, v in runs.items()}
    audio_rate = 16 * 4 / (model_ms['kernel'] / 1000)
    # K1's launches at B=16 T=3999 d=1, device ms a call from a trace
    from brever_tpu_torch import profile_tcn_bwd
    k1 = profile_tcn_bwd.profile(1, calls=3, forward=True)
    k1_parts = ', '.join(f'{name} {ms:.3f}' for name, ms in sorted(
        k1['parts'].items(), key=lambda kv: -kv[1]))
    phase(5, f'[{card}] block B=16 T=3999 kernel/plain ms: d=1 '
          f'{timing[1]["kernel"]:.3f}/{timing[1]["plain"]:.3f}, d=128 '
          f'{timing[128]["kernel"]:.3f}/{timing[128]["plain"]:.3f}; enhance '
          f'16x4 s {model_ms["kernel"]:.2f} ms (plain blocks '
          f'{model_ms["plain"]:.2f} ms), {audio_rate:.1f} audio s/s, peak '
          f'{peak / 2 ** 20:.1f} MiB; K1 launches at d=1, device ms a call: '
          f'{k1["ms"]:.3f} ms, {k1["launches"]:g} launches: {k1_parts}')

    # ---- phase 6: backward kernel vs plain version on the card
    rng = np.random.RandomState(6)
    bwd_worst, bwd_err, stats_err = float('inf'), 0.0, 0.0
    # phase 2's cases at C = Cs = 128, H = 512, then widths that leave
    # partial GEMM tiles (36/100/20, SMALL's 32/64/32) and widths off the
    # float4 grid, which take K2's single-float kernels (H 102; 130/257/21)
    widths = [(2, 300, 1, False, 36, 100, 20), (2, 129, 2, True, 32, 64, 32),
              (2, 300, 128, False, 36, 102, 20),
              (2, 77, 4, True, 130, 257, 21)]
    for batch, t_total, dilation, last, c, h, cs in \
            [case + (128, 512, 128) for case in cases] + widths:
        x, params = block_inputs(rng, batch, t_total, c=c, h=h, cs=cs)
        if last:
            params = params[:10] + (None, None) + params[12:]
        g_res = None if last else torch.from_numpy(
            rng.randn(batch, t_total, c).astype(np.float32)).to(device)
        g_skip = torch.from_numpy(
            rng.randn(batch, t_total, cs).astype(np.float32)).to(device)
        with torch.no_grad():
            (_, _, stats), act = tcn._launch(x, params, dilation, last)
            _, _, ref_stats = tcn.tcn_block_fwd_plain(x, params, dilation,
                                                      last)
        torch.testing.assert_close(stats, ref_stats, atol=1e-6, rtol=1e-5)
        stats_err = max(stats_err, ((stats - ref_stats).abs()
                                    / ref_stats.abs()).max().item())
        # K2's recomputed z1 is the forward's: PReLU of it is K1's h1
        with torch.no_grad():
            z1 = tcn.recompute_z1(x, params)
        if not torch.equal(torch.where(z1 >= 0, z1, params[2] * z1), act[0]):
            raise AssertionError(f'K2 B={batch} T={t_total}: the recomputed '
                                 'z1 is not the forward\'s')
        del z1
        dx, dparams = tcn.tcn_block_bwd(x, params, stats, g_res, g_skip,
                                        dilation, last)
        ref = block_vjp_f64(x, params, g_res, g_skip, dilation, last, act)
        del act
        torch.cuda.synchronize()
        name = (f'K2 B={batch} T={t_total} C={c} H={h} Cs={cs} d={dilation} '
                f'last={last}')
        worst, err = check_grads(name, ref, (dx,) + dparams)
        again = tcn.tcn_block_bwd(x, params, stats, g_res, g_skip, dilation,
                                  last)
        for got, rerun in zip((dx,) + dparams, (again[0],) + again[1]):
            if got is not None and not torch.equal(got, rerun):
                raise AssertionError(f'{name}: two runs differ')
        bwd_worst, bwd_err = min(bwd_worst, worst), max(bwd_err, err)
    # K2's launches at B=16 T=3999, device ms a call from a trace
    k2 = {d: profile_tcn_bwd.profile(d, calls=3) for d in (1, 128)}

    def k2_line(d):
        parts = sorted(k2[d]['parts'].items(), key=lambda kv: -kv[1])
        return (f'd={d} {k2[d]["ms"]:.3f} ms, {k2[d]["launches"]:g} launches: '
                + ', '.join(f'{name} {ms:.3f}' for name, ms in parts))

    phase(6, f'{len(cases)} block cases at C/H/Cs 128/512/128 and '
          f'{len(widths)} at ' + ', '.join(f'{c}/{h}/{cs}' for *_, c, h, cs
                                           in widths)
          + ': K2 dx and every parameter gradient agree with the plain block in float64 on K1\'s PReLU branches '
          f'(worst SNR {bwd_worst:.1f} dB >= {MIN_SNR_DB}, max abs err '
          f'{bwd_err:.3e}, each <= {MAX_REL_ERR} x max|ref|); two runs '
          f'bitwise equal; K2\'s recomputed z1 bitwise K1\'s in every case; '
          f'K1 stats within {stats_err:.1e} relative of the plain ones (rtol '
          f'1e-5, atol 1e-6); [{card}] K2 launches at B=16 T=3999, device ms '
          f'a call: {k2_line(1)}; {k2_line(128)}')

    # ---- phase 7: full-model gradients on the card vs the plain CPU path
    # in float64, which keeps each PReLU's input and output gradient
    rng = np.random.RandomState(7)
    target = 0.1 * rng.randn(2, 1, 2, 2 * FS)
    batch = np.concatenate([target + 0.1 * rng.randn(2, 1, 2, 2 * FS),
                            target], axis=1).astype(np.float32)
    lengths = np.array([2 * FS, 3 * FS // 2], np.int32)
    record = []
    convtasnet.tcn_block = \
        lambda x, params, d, last: block_f64(x, params, d, last,
                                             record=record)
    try:
        model = build_model('convtasnet', {}, flax_params, 'cpu').double()
        n = torch.from_numpy(lengths)
        sample_weighted_mean(model.loss(torch.from_numpy(batch).double(), n),
                             n).backward()
    finally:
        convtasnet.tcn_block = tcn.tcn_block
    ref = {k: p.grad.numpy() for k, p in model.named_parameters()}
    # the condition scale of a slope's gradient sum(gh min(z, 0)): the sum
    # of its terms' magnitudes
    scale = {f'tcn.blocks.{i // 2}.prelu_{i % 2 + 1}.alpha':
             (h.grad * z.detach().clamp(max=0)).abs().sum().item()
             for i, (z, h) in enumerate(record)}
    del model, record
    model = build_model('convtasnet', {}, flax_params, device)
    data, n = torch.from_numpy(batch).to(device), n.to(device)
    tcn.tcn_block_bwd.launches = 0
    got = torch.autograd.grad(sample_weighted_mean(model.loss(data, n), n),
                              list(model.parameters()))
    launches_bwd = tcn.tcn_block_bwd.launches
    got = {k: g.double().cpu().numpy()
           for (k, _), g in zip(model.named_parameters(), got)}
    del model
    if launches_bwd != 24:
        raise AssertionError(f'{launches_bwd} backward launches, not 24')
    # every gradient but the blocks' PReLU slopes: SNR >= 50 dB against
    # float64. Through 24 blocks float32 keeps about that much: the plain
    # float32 path reaches 55.6 dB (card) and 58.7 dB (CPU) at its worst
    # parameter on these inputs
    grad_snr = {k: snr_db(ref[k], got[k]) for k in ref if k not in scale}
    worst_name = min(grad_snr, key=grad_snr.get)
    whole = snr_db(np.concatenate([ref[k].ravel() for k in ref]),
                   np.concatenate([got[k].ravel() for k in ref]))
    # each block's PReLU slope: a sum of 2M terms that cancel by up to 1e5
    # times, held to 1e-5 of the sum of its terms' magnitudes (~170
    # float32 epsilons), where float32 ends on any path
    slope = max(abs(float(got[k][0]) - float(ref[k][0])) / scale[k]
                for k in scale)
    if grad_snr[worst_name] < 50 or whole < MIN_SNR_DB or slope > 1e-5:
        raise AssertionError(f'model gradients: worst {worst_name} '
                             f'{grad_snr[worst_name]:.2f} dB, whole '
                             f'{whole:.2f} dB, slopes {slope:.2e}')
    phase(7, f'full-model gradients (2 x 2 s, snr criterion) on the card vs '
          f'the plain path in float64 on the CPU: whole gradient '
          f'{whole:.1f} dB (>= {MIN_SNR_DB}), worst of {len(grad_snr)} '
          f'tensors {grad_snr[worst_name]:.1f} dB ({worst_name}; >= 50), '
          f'{len(scale)} PReLU slopes within {slope:.1e} of their terms\' '
          f'magnitude (<= 1e-5); {launches_bwd} backward launches')

    # ---- phase 8: training through train.main on the card
    keep = tempfile.mkdtemp()
    epochs = 24
    with tempfile.TemporaryDirectory() as tmp:
        model_dir = tone_model_dir(tmp, 'convtasnet', 10)
        first, second, train_s, (launches_train, launches_train_bwd) = \
            train_and_resume(lambda n: train_args(model_dir, n, 6), epochs,
                             [(tcn.tcn_block, 'launches'),
                              (tcn.tcn_block_bwd, 'launches')])
        if launches_train == 0 or launches_train_bwd == 0:
            raise AssertionError(f'training launched K1 {launches_train} '
                                 f'and K2 {launches_train_bwd} times')
        losses = first.loss_logger.train_loss
        drop = losses[0] - float(np.mean(losses[-3:]))
        if not np.isfinite(losses).all() or drop <= 1.0:
            raise AssertionError(f'training loss {losses[0]:.2f} -> '
                                 f'{np.mean(losses[-3:]):.2f} dB')
        ckpt = second.last_ckpt_path
        # phase 52 scores a test set with this directory
        shutil.copytree(model_dir, os.path.join(keep, 'convtasnet'))
        served = build_model('convtasnet', {},
                             load_checkpoint(ckpt)['params'], device)
        mix = second.val_dataset[0][0][None]
        want = second.model.enhance(mix)
        got = served.enhance(mix)
        if not torch.isfinite(got).all():
            raise AssertionError('the served checkpoint gives non-finite '
                                 'output')
        torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-5)
        metrics = [m for m in first.loss_logger.metrics if m][-1]
    phase(8, f'train.main, 24 x 1 s tone-in-noise WAV items, batch 8, '
          f'{epochs} epochs in {train_s:.1f} s: train loss {losses[0]:.2f} '
          f'-> {np.mean(losses[-3:]):.2f} dB, val snr {metrics["snr"]:.2f} '
          f'sisnr {metrics["sisnr"]:.2f} dB; K1 {launches_train} / K2 '
          f'{launches_train_bwd} launches; resumed bitwise from last.ckpt to '
          f'epoch {second.epochs_ran}; the checkpoint serves')

    # ---- phase 9: timings (plain, kernel, kernel, plain in turns)
    for dilation in (1, 128):
        x, params = block_inputs(np.random.RandomState(4), 16, 3999)
        g_res = torch.randn(16, 3999, 128, device=device)
        g_skip = torch.randn(16, 3999, 128, device=device)
        with torch.no_grad():
            _, _, stats = tcn.tcn_block_fwd(x, params, dilation, False)
        timing_bwd = in_turns({
            'kernel': lambda: tcn.tcn_block_bwd(
                x, params, stats, g_res, g_skip, dilation, False),
            'plain': lambda: tcn.tcn_block_bwd_plain(
                x, params, g_res, g_skip, dilation, False)}, 5, 2)[0]
        timing[dilation].update({'bwd_' + k: v for k, v in
                                 timing_bwd.items()})
    with tempfile.TemporaryDirectory() as tmp:
        step_trainer, data, n = make_trainer(device, tmp)

        def step(blocks):
            def run():
                convtasnet.tcn_block = blocks
                try:
                    step_trainer.train_step(data, n)
                finally:
                    convtasnet.tcn_block = tcn.tcn_block
            return run

        step_ms, step_peak = in_turns({'kernel': step(tcn.tcn_block),
                                       'plain': step(tcn.tcn_block_plain)},
                                      3, 1)
        del step_trainer, data
    phase(9, f'[{card}] block backward B=16 T=3999 kernel/plain ms: d=1 '
          f'{timing[1]["bwd_kernel"]:.3f}/{timing[1]["bwd_plain"]:.3f}, '
          f'd=128 {timing[128]["bwd_kernel"]:.3f}/'
          f'{timing[128]["bwd_plain"]:.3f}; train step 16x4 s f32 (fwd, bwd, '
          f'clip, Adam) {step_ms["kernel"]:.2f} ms (PR 9\'s run on the same '
          f'card model and limit: 158.77 ms), peak '
          f'{step_peak["kernel"] / 2 ** 20:.1f} MiB (plain blocks '
          f'{step_ms["plain"]:.2f} ms, peak '
          f'{step_peak["plain"] / 2 ** 20:.1f} MiB)')

    # Conv-TasNet's bf16 route next to its float32 phases, while the
    # process has taken few profiler traces
    amp = amp_phases(device, card)
    lamp = lstm_amp_phases(device, card)
    grid = tfgridnet_phases(device, card)
    sgm = sgmse_phases(device, card)
    dcc = dccrn_phases(device, card)
    mnr = manner_phases(device, card)
    stf = stft_phase(device, card)
    lstm_repair_phase(device, card)
    fma = fma_phase(device, card)
    wide = wide_scan_phase(device, card)
    idm = idmse_phases(device, card)
    kernel_size_phase(device, card)
    ffnn_phases(device)
    metric_phase(device, card)
    ffnn_times(device, card)
    try:
        host_metric_phase(device, card)
        mg = metricgan_phases(device, card)
        tested = test_model_phase(
            device, card, [('metricganp', mg['model_dir']),
                           ('convtasnet', os.path.join(keep, 'convtasnet'))])
        metricgan_times(device, card, mg, tested)
    finally:
        from brever_tpu_torch.pesq import close_pool
        close_pool()
        shutil.rmtree(keep, ignore_errors=True)
        if 'mg' in locals():
            shutil.rmtree(mg['tmp'], ignore_errors=True)
    # SGMSE+, IDMSE and MANNER under amp (their norms' bf16 route), last:
    # their traces run in fresh interpreters, and the earlier phases' own
    # traces lost their device events after these phases' work
    nbf = norm_bf16_phase(device, card)
    namp = norm_amp_phases(device, card)

    if any(m in sys.modules for m in ('jax', 'flax', 'optax',
                                      'brever_tpu')):
        raise AssertionError('the port pulled in JAX or the JAX package')
    shape = 'B=16 T=3999 C=128 H=512 Cs=128'
    # K1's bound: its three GEMMs (C->H, H->C and H->Cs) and the depthwise
    # taps; bytes of x in, the residual and skip out and the parameters.
    # K2 recomputes the forward's products and takes dX and dW of each
    rows, c, h, cs = 16 * 3999, 128, 512, 128
    tcn_flops = 2 * rows * (c * h + h * (c + cs) + 3 * h)
    tcn_weights = c * h + h * (c + cs) + 12 * h + c + cs
    k1_bound = bound(tcn_flops, 4 * (rows * (2 * c + cs) + tcn_weights))
    k2_bound = bound(3 * tcn_flops, 4 * (rows * (3 * c + cs)
                                         + 2 * tcn_weights))
    # the bf16 route: the same operations at the card's bf16 tensor-core
    # rate, 2 bytes an element (the parameter gradients too)
    k1_bf16_bound = bound(tcn_flops, 2 * (rows * (2 * c + cs) + tcn_weights),
                          BF16_FLOPS)
    k2_bf16_bound = bound(3 * tcn_flops, 2 * (rows * (3 * c + cs)
                                              + 2 * tcn_weights), BF16_FLOPS)
    lstm_t = grid['timing']['intra']
    gn_big = sgm['largest']
    scan_t, scan_t1 = dcc['timing']['layer0'], dcc['timing']['layer1']
    print(json.dumps({'kernels': [{
        'name': 'tcn_block_fwd',
        'route': 'cuda',
        'source': 'brever_tpu_torch/csrc/tcn_block.cu',
        'replaces': 'brever_tpu/ops/pallas/tcn_block.py:481',
        'launches': launches + launches_train,
        'launches_serve': launches,
        'launches_train': launches_train,
        'max_abs_err': max_err,
        'ms': timing[1]['kernel'],
        'plain_ms': timing[1]['plain'],
        'ms_d128': timing[128]['kernel'],
        'plain_ms_d128': timing[128]['plain'],
        'parts_ms': k1['parts'],
        'bound_ms': k1_bound[0],
        'bound_by': k1_bound[1],
        'library_ms': None,
        'shape': shape,
    }, {
        'name': 'tcn_block_bwd',
        'route': 'cuda',
        'source': 'brever_tpu_torch/csrc/tcn_block_bwd.cu',
        'replaces': 'brever_tpu/ops/pallas/tcn_block.py:665',
        'launches': launches_train_bwd,
        'max_abs_err': bwd_err,
        'ms': timing[1]['bwd_kernel'],
        'plain_ms': timing[1]['bwd_plain'],
        'ms_d128': timing[128]['bwd_kernel'],
        'plain_ms_d128': timing[128]['bwd_plain'],
        'bound_ms': k2_bound[0],
        'bound_by': k2_bound[1],
        'library_ms': None,
        'shape': shape,
        'train_step_ms': step_ms['kernel'],
        'train_step_plain_ms': step_ms['plain'],
        'parts_ms': k2[1]['parts'],
        'parts_ms_d128': k2[128]['parts'],
        'launches_a_call': k2[1]['launches'],
    }, {
        'name': 'tcn_block_fwd_bf16',
        'route': 'cuda',
        'source': 'brever_tpu_torch/csrc/tcn_block.cu',
        'replaces': 'brever_tpu/ops/pallas/tcn_block.py:481',
        'launches': amp['launches'][0],
        'max_abs_err': amp['out_err'],
        'ms': amp['fwd_ms']['kernel'],
        'plain_ms': amp['fwd_ms']['plain'],
        'plain_note': 'the bf16 plain twin (float32 arithmetic on the bf16 '
                      'values, the TPU kernel\'s rounding points)',
        'parts_ms': amp['parts']['k1'] and amp['parts']['k1']['parts'],
        'launches_a_call': amp['parts']['k1']
        and amp['parts']['k1']['launches'],
        'bound_ms': k1_bf16_bound[0],
        'bound_by': k1_bf16_bound[1],
        'bound_note': 'bytes at 3.35 TB/s, operations at the bf16 '
                      'tensor-core rate of 989 TFLOP/s',
        'library_ms': None,
        'shape': shape + ' bf16',
        'amp_step_k1_ms': amp['k1_step'],
    }, {
        'name': 'tcn_block_bwd_bf16',
        'route': 'cuda',
        'source': 'brever_tpu_torch/csrc/tcn_block_bwd.cu',
        'replaces': 'brever_tpu/ops/pallas/tcn_block.py:665',
        'launches': amp['launches'][1],
        'max_abs_err': amp['bwd_err'],
        'worst_snr_vs_twin_db': amp['worst_twin_db'],
        'ms': amp['bwd_ms']['kernel'],
        'plain_ms': amp['bwd_ms']['plain'],
        'parts_ms': amp['parts']['k2'] and amp['parts']['k2']['parts'],
        'launches_a_call': amp['parts']['k2']
        and amp['parts']['k2']['launches'],
        'bound_ms': k2_bf16_bound[0],
        'bound_by': k2_bf16_bound[1],
        'library_ms': None,
        'shape': shape + ' bf16',
        'amp_step_k2_ms': amp['k2_step'],
        'amp_train_step_ms': amp['step_ms']['kernel'],
        'f32_train_step_ms': amp['step_ms']['plain'],
        'amp_train_step_peak_mib': amp['step_peak']['kernel'] / 2 ** 20,
        'amp_step_device_idle_share': amp['idle'],
    }, {
        'name': 'lstm_scan_x_fwd',
        'route': 'cuda',
        'source': 'brever_tpu_torch/csrc/lstm_scan.cuh',
        'replaces': 'brever_tpu/ops/pallas/lstm_scan.py:401',
        'launches': grid['launches_serve'] + grid['launches_train']
        + grid['launches_http'],
        'launches_serve': grid['launches_serve'] + grid['launches_http'],
        'launches_train': grid['launches_train'],
        'max_abs_err': grid['k3_err'],
        'ms': grid['timing']['intra']['fwd']['kernel'],
        'plain_ms': grid['timing']['intra']['fwd']['plain'],
        'ms_inter': grid['timing']['inter']['fwd']['kernel'],
        'plain_ms_inter': grid['timing']['inter']['fwd']['plain'],
        'bound_ms': lstm_t['bound_fwd'][0],
        'bound_by': lstm_t['bound_fwd'][1],
        'library_ms': lstm_t['lib_fwd'],
        'library_ms_inter': grid['timing']['inter']['lib_fwd'],
        'plan': grid['timing']['intra']['fwd_plan'],
        'plan_inter': grid['timing']['inter']['fwd_plan'],
        'shape': 'intra T=33 D=2 R=8064 E=H=128; inter T=126 R=2112',
        'enhance_16x4s_ms': grid['enhance_ms']['kernel'],
        'enhance_16x4s_plain_ms': grid['enhance_ms']['plain'],
    }, {
        'name': 'lstm_scan_x_bwd',
        'route': 'cuda',
        'source': 'brever_tpu_torch/csrc/lstm_scan.cuh',
        'replaces': 'brever_tpu/ops/pallas/lstm_scan.py:503',
        'launches': grid['launches_train_bwd'],
        'max_abs_err': grid['k4_err'],
        'ms': grid['timing']['intra']['bwd']['kernel'],
        'plain_ms': grid['timing']['intra']['bwd']['plain'],
        'ms_inter': grid['timing']['inter']['bwd']['kernel'],
        'plain_ms_inter': grid['timing']['inter']['bwd']['plain'],
        'bound_ms': lstm_t['bound_bwd'][0],
        'bound_by': lstm_t['bound_bwd'][1],
        'library_ms': lstm_t['lib_bwd'],
        'library_ms_inter': grid['timing']['inter']['lib_bwd'],
        'library_note': 'the backward of nn.LSTM (cuDNN), bidirectional, '
                        'over the same (T, R, E) input: data and both '
                        'weight sets',
        'parts_ms': lstm_t['parts'],
        'parts_ms_inter': grid['timing']['inter']['parts'],
        'plan': lstm_t['plan'],
        'plan_inter': grid['timing']['inter']['plan'],
        'shape': 'intra T=33 D=2 R=8064 E=H=128; inter T=126 R=2112',
        'train_step_ms': grid['step_ms']['kernel'],
        'train_step_plain_ms': grid['step_ms']['plain'],
    }, {
        'name': 'lstm_scan_x_fwd_bf16',
        'route': 'cuda',
        'source': 'brever_tpu_torch/csrc/lstm_scan_bf16.cu',
        'replaces': 'brever_tpu/ops/pallas/lstm_scan.py:401',
        'instruction': 'mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 '
                       '(csrc/mma_bf16.cuh)',
        'hmma_bf16_sass': {k: n for k, n in lamp['hmma'].items()
                           if k.startswith('lstm_fwd')},
        'launches': lamp['train']['tfgridnet']['launches'][0]
        + lamp['train']['dccrn']['launches'][0],
        'launches_tfgridnet_train': lamp['train']['tfgridnet']['launches'][0],
        'max_abs_err': lamp['err']['k3'],
        'worst_snr_vs_twin_db': lamp['worst_db']['k3'],
        'ms': lamp['timing']['intra']['fwd']['kernel'],
        'plain_ms': lamp['timing']['intra']['fwd']['plain'],
        'plain_note': 'the bf16 plain twin (the TPU kernel\'s rounding '
                      'points), on the card',
        'ms_inter': lamp['timing']['inter']['fwd']['kernel'],
        'plain_ms_inter': lamp['timing']['inter']['fwd']['plain'],
        'bound_ms': lamp['timing']['intra']['bound_fwd'][0],
        'bound_by': lamp['timing']['intra']['bound_fwd'][1],
        'bound_note': 'bytes at 2 an element and 3.35 TB/s, operations at '
                      'the bf16 tensor-core rate of 989 TFLOP/s',
        'library_ms': lamp['timing']['intra']['lib_fwd'],
        'library_ms_inter': lamp['timing']['inter']['lib_fwd'],
        'library_note': 'nn.LSTM (cuDNN) in bf16, bidirectional, over the '
                        'same (T, R, E) input',
        'shape': 'intra T=33 D=2 R=8064 E=H=128 bf16; inter T=126 R=2112',
        'amp_train_step_ms': lamp['steps']['tfgridnet']['ms']['kernel'],
        'f32_train_step_ms': lamp['steps']['tfgridnet']['ms']['plain'],
        'amp_train_step_peak_mib':
            lamp['steps']['tfgridnet']['peak']['kernel'] / 2 ** 20,
        'f32_train_step_peak_mib':
            lamp['steps']['tfgridnet']['peak']['plain'] / 2 ** 20,
        'amp_step_lstm_ms': lamp['steps']['tfgridnet']['lstm_ms'],
        'amp_step_device_idle_share': lamp['steps']['tfgridnet']['idle'],
    }, {
        'name': 'lstm_scan_x_bwd_bf16',
        'route': 'cuda',
        'source': 'brever_tpu_torch/csrc/lstm_scan_bf16.cu',
        'replaces': 'brever_tpu/ops/pallas/lstm_scan.py:503',
        'instruction': 'mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 '
                       '(csrc/mma_bf16.cuh)',
        'hmma_bf16_sass': {k: n for k, n in lamp['hmma'].items()
                           if not k.startswith('lstm_fwd')},
        'parts_ms': lamp['timing']['intra']['parts'],
        'parts_ms_inter': lamp['timing']['inter']['parts'],
        'launches': lamp['train']['tfgridnet']['launches'][1]
        + lamp['train']['dccrn']['launches'][1],
        'max_abs_err': lamp['err']['k4'],
        'worst_snr_vs_twin_db': lamp['worst_db']['k4'],
        'ms': lamp['timing']['intra']['bwd']['kernel'],
        'plain_ms': lamp['timing']['intra']['bwd']['plain'],
        'ms_inter': lamp['timing']['inter']['bwd']['kernel'],
        'plain_ms_inter': lamp['timing']['inter']['bwd']['plain'],
        'bound_ms': lamp['timing']['intra']['bound_bwd'][0],
        'bound_by': lamp['timing']['intra']['bound_bwd'][1],
        'library_ms': lamp['timing']['intra']['lib_bwd'],
        'library_ms_inter': lamp['timing']['inter']['lib_bwd'],
        'library_note': 'the backward of that bf16 nn.LSTM (data and both '
                        'weight sets)',
        'shape': 'intra T=33 D=2 R=8064 E=H=128 bf16; inter T=126 R=2112',
    }, {
        'name': 'lstm_scan_fwd_bf16',
        'route': 'cuda',
        'source': 'brever_tpu_torch/csrc/lstm_scan.cuh',
        'replaces': 'brever_tpu/ops/pallas/lstm_scan.py:155',
        'launches': lamp['train']['tfgridnet']['launches'][2]
        + lamp['train']['dccrn']['launches'][2],
        'launches_dccrn_train': lamp['train']['dccrn']['launches'][2],
        'max_abs_err': lamp['err']['k5'],
        'worst_snr_vs_twin_db': lamp['worst_db']['k5'],
        'ms': lamp['timing']['dccrn']['fwd']['kernel'],
        'plain_ms': lamp['timing']['dccrn']['fwd']['plain'],
        'bound_ms': lamp['timing']['dccrn']['bound_fwd'][0],
        'bound_by': lamp['timing']['dccrn']['bound_fwd'][1],
        'library_ms': lamp['timing']['dccrn']['lib_fwd'],
        'library_note': 'nn.LSTM (cuDNN) in bf16 over (T=495, 32, E=512), '
                        'bidirectional: both weight sets, the input '
                        'projection inside',
        'shape': 'T=495 D=2 R=32 H=128 bf16 (DCCRN at 16 x 4 s, gates from '
                 'E=512)',
        'amp_train_step_ms': lamp['steps']['dccrn']['ms']['kernel'],
        'f32_train_step_ms': lamp['steps']['dccrn']['ms']['plain'],
        'amp_train_step_peak_mib':
            lamp['steps']['dccrn']['peak']['kernel'] / 2 ** 20,
        'f32_train_step_peak_mib':
            lamp['steps']['dccrn']['peak']['plain'] / 2 ** 20,
        'amp_step_lstm_ms': lamp['steps']['dccrn']['lstm_ms'],
        'amp_step_device_idle_share': lamp['steps']['dccrn']['idle'],
    }, {
        'name': 'lstm_scan_bwd_bf16',
        'route': 'cuda',
        'source': 'brever_tpu_torch/csrc/lstm_scan.cuh',
        'replaces': 'brever_tpu/ops/pallas/lstm_scan.py:235',
        'launches': lamp['train']['tfgridnet']['launches'][3]
        + lamp['train']['dccrn']['launches'][3],
        'max_abs_err': lamp['err']['k6'],
        'worst_snr_vs_twin_db': lamp['worst_db']['k6'],
        'ms': lamp['timing']['dccrn']['bwd']['kernel'],
        'plain_ms': lamp['timing']['dccrn']['bwd']['plain'],
        'bound_ms': lamp['timing']['dccrn']['bound_bwd'][0],
        'bound_by': lamp['timing']['dccrn']['bound_bwd'][1],
        'library_ms': lamp['timing']['dccrn']['lib_bwd'],
        'library_note': 'the backward of that bf16 nn.LSTM (data and '
                        'weights)',
        'shape': 'T=495 D=2 R=32 H=128 bf16 (DCCRN at 16 x 4 s)',
    }, {
        'name': 'group_norm_act_fwd',
        'route': 'cuda',
        'source': 'brever_tpu_torch/csrc/groupnorm.cu',
        'replaces': 'brever_tpu/ops/pallas/groupnorm.py:134',
        'launches': sgm['launches_train'] + sgm['launches_http']
        + idm['launches_train'] + idm['launches_http'],
        'launches_serve': sgm['launches_http'],
        'launches_train': sgm['launches_train'],
        'launches_idmse_serve': idm['launches_http'],
        'launches_idmse_train': idm['launches_train'],
        'launches_recompute': sgm['recompute_train'],
        'launches_per_eval': sgm['launches_eval'],
        'max_abs_err': sgm['k7_err'],
        'ms': gn_big['fwd']['kernel'],
        'plain_ms': gn_big['fwd']['plain'],
        'bound_ms': gn_big['bound'][0][0],
        'bound_by': gn_big['bound'][0][1],
        'library_ms': gn_big['fwd']['library'],
        'shape': 'B=4 C=256 F=256 T=501 G=32 SiLU',
        'launches_a_call': sgm['launches_a_call']['k7'],
        'card_ms': gn_big['fwd']['card'],
        'host_ms': gn_big['fwd']['host'],
        'eval_4x4s_ms': sgm['eval']['k7'],
        'eval_4x4s_card_ms': sgm['eval']['k7_card'],
        'eval_4x4s_host_ms_a_call': sgm['eval']['k7_host'],
        'eval_4x4s_plain_ms': sgm['eval']['plain'],
        'eval_4x4s_bound_ms': sgm['eval']['bound_k7'],
        'eval_4x4s_library_ms': sgm['eval']['library'],
        'routes': {str(tuple(r['shape'])): [r['route'], r['cluster']]
                   for r in sgm['eval_rows']},
        'timing_note': 'ms, plain_ms, library_ms, eval_4x4s_*: calls as '
                       'the host issues them (CUDA events); card_ms, '
                       'eval_4x4s_card_ms: calls queued behind a sleep '
                       'kernel (the card\'s time)',
        'denoiser_4x4s_ms': sgm['den_ms']['kernel'],
        'denoiser_4x4s_plain_ms': sgm['den_ms']['plain'],
        'enhance_1x2s_ms': sgm['enh_ms']['kernel'],
        'enhance_1x2s_plain_ms': sgm['enh_ms']['plain'],
        'idmse_denoiser_4x4s_ms': idm['den_ms']['kernel'],
        'idmse_denoiser_4x4s_plain_ms': idm['den_ms']['plain'],
        'idmse_enhance_1x2s_ms': idm['enh_ms'],
        'idmselarge_enhance_1x2s_s': idm['large']['enhance_s'],
        'launches_idmselarge': idm['launches_large'],
    }, {
        'name': 'group_norm_act_bwd',
        'route': 'cuda',
        'source': 'brever_tpu_torch/csrc/groupnorm.cu',
        'replaces': 'brever_tpu/ops/pallas/groupnorm.py:263',
        'launches': sgm['launches_train_bwd'] + idm['launches_train_bwd'],
        'launches_idmse_train': idm['launches_train_bwd'],
        'max_abs_err': sgm['k8_err'],
        'ms': gn_big['bwd']['kernel'],
        'plain_ms': gn_big['bwd']['plain'],
        'bound_ms': gn_big['bound'][1][0],
        'bound_by': gn_big['bound'][1][1],
        'library_ms': gn_big['bwd']['library'],
        'shape': 'B=4 C=256 F=256 T=501 G=32 SiLU',
        'launches_a_call': sgm['launches_a_call']['k8'],
        'card_ms': gn_big['bwd']['card'],
        'host_ms': gn_big['bwd']['host'],
        'eval_4x4s_ms': sgm['eval']['k8'],
        'eval_4x4s_card_ms': sgm['eval']['k8_card'],
        'eval_4x4s_host_ms_a_call': sgm['eval']['k8_host'],
        'eval_4x4s_plain_ms': sgm['eval']['plain_bwd'],
        'eval_4x4s_bound_ms': sgm['eval']['bound_k8'],
        'eval_4x4s_library_ms': sgm['eval']['library_bwd'],
        'routes': {str(tuple(r['shape'])): [r['route'], r['cluster']]
                   for r in sgm['eval_rows']},
        'train_step_4x4s_ms': sgm['steps']['4'][0]['kernel'],
        'train_step_4x4s_plain_ms': sgm['steps']['4'][0]['plain'],
        'train_step_8x4s_ms': sgm['steps']['8'][0],
        'idmse_train_step_4x4s_ms': idm['step_ms']['kernel'],
        'idmse_train_step_4x4s_plain_ms': idm['step_ms']['plain'],
        'idmselarge_train_step_4x4s_ms': idm['large']['step_ms'],
        'idmselarge_train_step_4x4s_peak_mib':
            idm['large']['step_peak'] / 2 ** 20,
    }, {
        'name': 'lstm_scan_fwd',
        'route': 'cuda',
        'source': 'brever_tpu_torch/csrc/lstm_scan.cuh',
        'replaces': 'brever_tpu/ops/pallas/lstm_scan.py:155',
        'launches': dcc['launches_serve'] + dcc['launches_train']
        + dcc['launches_http'] + grid['k5_launches_http']
        + mg['launches_serve'] + mg['launches_train'],
        'launches_serve': dcc['launches_serve'] + dcc['launches_http']
        + grid['k5_launches_http'] + mg['launches_serve'],
        'launches_train': dcc['launches_train'] + mg['launches_train'],
        'launches_metricgan_serve': mg['launches_serve'],
        'launches_metricgan_train': mg['launches_train'],
        'launches_per_eval': dcc['launches_eval'],
        'max_abs_err': dcc['k5_err'],
        'ms': scan_t['fwd']['kernel'],
        'plain_ms': scan_t['fwd']['plain'],
        'us_per_step': 1e3 * scan_t['fwd']['kernel'] / DCCRN_LSTM[0][0],
        'bound_ms': scan_t['bound_fwd'][0],
        'bound_by': scan_t['bound_fwd'][1],
        'library_ms': scan_t['lib_fwd'],
        'library_ms_one_dir': scan_t['lib_fwd_one'],
        'library_note': 'nn.LSTM (cuDNN) over (T=495, 32, E=512), '
                        'bidirectional: both weight sets, the work of one K5 '
                        'launch over D=2, the input projection inside (no '
                        'PyTorch call takes precomputed gates); one_dir: one '
                        'weight set',
        'cluster': scan_cluster_record(dcc['timing']),
        'projection_then_k5_ms': scan_t['fwd']['route'],
        'k3_same_shape_ms': scan_t['fwd']['k3'],
        'projection_then_k5_ms_e128': scan_t1['fwd']['route'],
        'k3_same_shape_ms_e128': scan_t1['fwd']['k3'],
        'shape': 'T=495 D=2 R=32 H=128 (DCCRN at 16 x 4 s, gates from '
                 'E=512)',
        'enhance_16x4s_ms': dcc['enhance_ms']['kernel'],
        'enhance_16x4s_plain_ms': dcc['enhance_ms']['plain'],
        'ms_h512': wide['fwd']['kernel'],
        'plain_ms_h512': wide['fwd']['plain'],
        'bound_ms_h512': wide['bound_fwd'][0],
        'shape_h512': 'T=495 D=2 R=32 H=512 (16-row tiles)',
    }, {
        'name': 'lstm_scan_bwd',
        'route': 'cuda',
        'source': 'brever_tpu_torch/csrc/lstm_scan.cuh',
        'replaces': 'brever_tpu/ops/pallas/lstm_scan.py:235',
        'launches': dcc['launches_train_bwd'] + mg['launches_train_bwd'],
        'launches_metricgan_train': mg['launches_train_bwd'],
        'launches_per_backward': dcc['launches_bwd_step'],
        'max_abs_err': dcc['k6_err'],
        'ms': scan_t['bwd']['kernel'],
        'plain_ms': scan_t['bwd']['plain'],
        'bound_ms': scan_t['bound_bwd'][0],
        'bound_by': scan_t['bound_bwd'][1],
        'library_ms': scan_t['lib_bwd'],
        'library_ms_one_dir': scan_t['lib_bwd_one'],
        'library_note': 'the backward of that nn.LSTM (data and weights)',
        'cluster': scan_cluster_record(dcc['timing'], 'bwd'),
        'k4_same_shape_ms': scan_t['bwd']['k4'],
        'k4_same_shape_ms_e128': scan_t1['bwd']['k4'],
        'shape': 'T=495 D=2 R=32 H=128 (DCCRN at 16 x 4 s)',
        'train_step_ms': dcc['step_ms']['kernel'],
        'train_step_plain_ms': dcc['step_ms']['plain'],
        'ms_h512': wide['bwd']['kernel'],
        'plain_ms_h512': wide['bwd']['plain'],
        'bound_ms_h512': wide['bound_bwd'][0],
        'shape_h512': 'T=495 D=2 R=32 H=512 (16-row tiles)',
    }, {
        'name': 'bn_act_fwd',
        'route': 'cuda',
        'source': 'brever_tpu_torch/csrc/groupnorm.cu',
        'replaces': 'brever_tpu/ops/pallas/groupnorm.py:134',
        'launches': mnr['launches_train'],
        'launches_train': mnr['launches_train'],
        'launches_serve': mnr['launches_serve'],
        'launches_per_step': mnr['launches_step'][0],
        'max_abs_err': mnr['fwd_err'],
        'ms': mnr['largest']['fwd']['kernel'],
        'plain_ms': mnr['largest']['fwd']['plain'],
        'bound_ms': mnr['largest']['bound'][0][0],
        'bound_by': mnr['largest']['bound'][0][1],
        'library_ms': mnr['largest']['fwd']['library'],
        'library_note': 'F.batch_norm(training=True) + F.relu',
        'shape': 'B=16 C=60 T=64084 ReLU (MANNER in_bn at 16 x 4 s)',
        'card_ms': mnr['largest']['fwd']['card'],
        'host_ms': mnr['largest']['fwd']['host'],
        'launches_a_call': mnr['launches_a_call']['fwd'],
        'routes': {s: [r[0], r[2]] for s, r in mnr['routes'].items()},
        'step_16x4s_sum_ms': mnr['per_step']['k7'],
        'step_16x4s_sum_card_ms': mnr['per_step']['k7_card'],
        'step_16x4s_host_ms_a_call': mnr['per_step']['k7_host'],
        'step_16x4s_sum_plain_ms': mnr['per_step']['plain'],
        'step_16x4s_sum_library_ms': mnr['per_step']['library'],
        'step_16x4s_sum_bound_ms': mnr['per_step']['bound_k7'],
        'enhance_16x4s_ms': mnr['enhance_ms'],
    }, {
        'name': 'bn_act_bwd',
        'route': 'cuda',
        'source': 'brever_tpu_torch/csrc/groupnorm.cu',
        'replaces': 'brever_tpu/ops/pallas/groupnorm.py:263',
        'launches': mnr['launches_train_bwd'],
        'launches_per_step': mnr['launches_step'][1],
        'max_abs_err': mnr['bwd_err'],
        'ms': mnr['largest']['bwd']['kernel'],
        'plain_ms': mnr['largest']['bwd']['plain'],
        'bound_ms': mnr['largest']['bound'][1][0],
        'bound_by': mnr['largest']['bound'][1][1],
        'library_ms': mnr['largest']['bwd']['library'],
        'library_note': 'the backward of F.batch_norm(training=True) + '
                        'F.relu (data, scale and bias)',
        'shape': 'B=16 C=60 T=64084 ReLU (MANNER in_bn at 16 x 4 s)',
        'card_ms': mnr['largest']['bwd']['card'],
        'host_ms': mnr['largest']['bwd']['host'],
        'card_ms_by_route': mnr['candidates'],
        'launches_a_call': mnr['launches_a_call']['bwd'],
        'routes': {s: [r[1], r[2]] for s, r in mnr['routes'].items()},
        'step_16x4s_sum_ms': mnr['per_step']['k8'],
        'step_16x4s_sum_card_ms': mnr['per_step']['k8_card'],
        'step_16x4s_host_ms_a_call': mnr['per_step']['k8_host'],
        'step_16x4s_sum_plain_ms': mnr['per_step']['plain_bwd'],
        'step_16x4s_sum_library_ms': mnr['per_step']['library_bwd'],
        'step_16x4s_sum_bound_ms': mnr['per_step']['bound_k8'],
        'train_step_ms': mnr['step_ms']['kernel'],
        'train_step_plain_ms': mnr['step_ms']['plain'],
        'train_step_peak_mib': mnr['step_peak']['kernel'] / 2 ** 20,
    }, {
        'name': 'stft_fwd',
        'route': 'cuda',
        'source': 'brever_tpu_torch/csrc/stft.cu',
        'replaces': 'brever_tpu/ops/pallas/stft_kernel.py:37',
        'launches': stf['launches'] + stf['launches_dense'],
        'launches_fft_route': stf['launches'],
        'launches_dense_route': stf['launches_dense'],
        'max_abs_err': stf['err'],
        'k9_route': stf['512/128']['route'],
        'ms': stf['512/128']['kernel'],
        'plain_ms': stf['512/128']['plain'],
        'bound_ms': stf['512/128']['bound'][0],
        'bound_by': stf['512/128']['bound'][1],
        'library_ms': stf['512/128']['library'],
        'library_note': 'torch.stft (cuFFT), same window and frames',
        'shape': 'rows=16 n_fft=512 hop=128 over 4 s (DCCRN, SGMSE+)',
        'ms_256': stf['256/128']['kernel'],
        'plain_ms_256': stf['256/128']['plain'],
        'bound_ms_256': stf['256/128']['bound'][0],
        'library_ms_256': stf['256/128']['library'],
        'ms_4096': stf['4096/1024']['kernel'],
        'plain_ms_4096': stf['4096/1024']['plain'],
        'bound_ms_4096': stf['4096/1024']['bound'][0],
        'library_ms_4096': stf['4096/1024']['library'],
        'call_ms': stf['512/128']['paced']['kernel'],
        'call_library_ms': stf['512/128']['paced']['library'],
        'host_ms': stf['512/128']['host']['kernel'],
        'timing_note': 'ms, plain_ms, library_ms: CUDA events around calls '
                       'queued behind a sleep kernel (the card\'s time); '
                       'call_ms: calls as the host issues them',
        'dense_route_ms_400': stf['400/100']['kernel'],
        'dense_route_plain_ms_400': stf['400/100']['plain'],
        'dense_route_bound_ms_400': stf['400/100']['bound'][0],
        'dense_route_library_ms_400': stf['400/100']['library'],
        'dense_product_bound_ms': stf['512/128']['dense_bound'][0],
        'module_forward_ms': stf['module_ms'],
    }, *norm_bf16_records(nbf, namp), fma]}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    main()
