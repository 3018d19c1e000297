"""Smoke run of the PyTorch/CUDA port (brever_tpu_torch) on one GPU.

Drives the port's serving and training paths for full-width non-causal
Conv-TasNet (filters 512, bottleneck 128, hidden 512, skip 128, 8 layers
x 3 repeats; 4,935,217 random parameters from a numpy seed) and
full-width TF-GridNet (n_fft 256, stride 128, 6 layers, LSTM hidden 128,
4 heads, qk 512, emb 32, ks = hs = 4; 3,735,344 random parameters from a
seed) on the card, in phases that each print one line:

0. the card (nvidia-smi name and power limit), versions, optional deps;
1. build the CUDA kernels from brever_tpu_torch/csrc with nvcc;
2. the TCN block forward kernel (K1) against its plain PyTorch version;
3. the full model's enhance on the card against the plain path on a
   CPU copy;
4. the HTTP service (/health, three /enhance requests) on the card;
5. timings: per-block forward kernel vs plain version, full enhance;
6. the TCN block backward kernel (K2) against its plain version, and
   twice on the same inputs (bitwise equal);
7. full-model gradients on the card against the plain CPU path;
8. training through BreverTrainer on a WAV dataset written here: the
   loss falls, last.ckpt resumes, the checkpoint serves;
9. timings: per-block backward kernel vs plain version, the full train
   step with kernel and with plain blocks, peak memory;
10. the LSTM kernels (K3 forward, K4 backward) against their plain
    versions at TF-GridNet's intra and inter shapes and ragged ones, the
    backward in float64, and twice on the same inputs (bitwise equal);
11. TF-GridNet's enhance on the card against the plain path in float64;
12. TF-GridNet's full-model gradients (multiresyu) against the plain
    path in float64, beside the plain float32 path's;
13. TF-GridNet trained through BreverTrainer on a WAV dataset written
    here: the loss falls, last.ckpt resumes bitwise, the checkpoint serves;
14. the HTTP service over that model directory's checkpoint;
15. timings: K3 and K4 per BLSTM vs plain, enhance and the train step
    with kernel and with plain LSTMs, peak memory.

Float32 throughout, with TF32 off for cuDNN and cuBLAS so that the
comparisons hold the kernels to float32. Any failure raises (non-zero
exit). The line before the last is a JSON record of each kernel, the
last line ``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py
"""

import contextlib
import http.client
import io
import json
import os
import platform
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


def phase(n, text):
    print(f'phase {n}: {text}', flush=True)


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


def write_tone_dataset(path, n_items, seconds, seed):
    """A WAV dataset in the layout BreverDataset reads (``audio.tar``
    with ``audio/{i:05d}_{mixture,foreground}.wav``, two channels): a
    low-frequency tone in white noise at about 0 dB."""
    from brever_tpu_torch.audio import write_wav
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
                write_wav(buf, np.stack([x, x], axis=1).astype(np.float32),
                          FS)
                info = tarfile.TarInfo(f'audio/{i:05d}_{name}.wav')
                info.size = buf.tell()
                buf.seek(0)
                tar.addfile(info, buf)


def tone_trainers(tmp, arch, device, seed, val_period):
    """Writes train (24 items) and val (4) tone datasets of 1 s under
    ``tmp``; returns a factory of ``BreverTrainer``s of the default
    ``arch`` over them, batch 8, into ``tmp/model``."""
    from brever_tpu_torch.data import BreverDataset
    from brever_tpu_torch.models import ModelRegistry
    from brever_tpu_torch.training import BreverTrainer
    for split, n_items, data_seed in (('train', 24, seed), ('val', 4,
                                                             seed + 1)):
        write_tone_dataset(os.path.join(tmp, split), n_items, 1.0, data_seed)

    def trainer(n_epochs):
        return BreverTrainer(
            ModelRegistry.get(arch)(device='cpu'),
            BreverDataset(os.path.join(tmp, 'train')),
            BreverDataset(os.path.join(tmp, 'val')),
            os.path.join(tmp, 'model'), epochs=n_epochs, device=str(device),
            batch_sampler='random', batch_size=8, dynamic_batch_size=False,
            val_metrics={'snr', 'sisnr'}, val_period=val_period, seed=0)
    return trainer


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
    kernel, plain, and the peak device memory of each."""
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


@contextlib.contextmanager
def plain_lstms():
    """Every BLSTM of the port runs the plain scan (forward and its
    memory-lean backward) instead of K3 and K4."""
    from brever_tpu_torch.models import rnn
    from brever_tpu_torch.ops import lstm_scan
    rnn.lstm_scan_x = lstm_scan.lstm_scan_x_plain
    try:
        yield
    finally:
        rnn.lstm_scan_x = lstm_scan.lstm_scan_x


def lstm_inputs(rng, steps, n_dir, rows, feat, hidden, device='cuda'):
    def arr(*s, scale=1.0):
        return torch.from_numpy((scale * rng.randn(*s)).astype(np.float32)) \
            .to(device)

    return (arr(steps, n_dir, rows, feat),
            arr(n_dir, feat, 4 * hidden, scale=hidden ** -0.5),
            arr(n_dir, 4 * hidden, scale=0.1),
            arr(n_dir, hidden, 4 * hidden, scale=hidden ** -0.5),
            arr(steps, n_dir, rows, hidden))


def offset_view(t):
    """A copy of ``t`` one float into a larger buffer: contiguous, but not
    16-byte aligned, like a parameter in the trainer's flat buffer."""
    buf = t.new_empty(t.numel() + 1)
    buf[1:].copy_(t.reshape(-1))
    return buf[1:].view(t.shape)


def check_tensors(name, labels, refs, gots):
    """SNR and max-error bounds of each tensor against its reference (an
    all-zero reference wants an all-zero result); returns (worst SNR, max
    abs err)."""
    worst, max_err = float('inf'), 0.0
    for label, want, have in zip(labels, refs, gots):
        want = want.detach().double().cpu()
        have = have.detach().double().cpu().reshape(want.shape)
        if not torch.isfinite(have).all():
            raise AssertionError(f'{name} {label}: not finite')
        err = (have - want).abs().max().item()
        if not want.any():
            if err:
                raise AssertionError(f'{name} {label}: {err:.3e} off 0')
            continue
        snr = snr_db(want.numpy(), have.numpy())
        bound = MAX_REL_ERR * want.abs().max().item()
        if snr < MIN_SNR_DB or err > bound:
            raise AssertionError(f'{name} {label}: SNR {snr:.2f} dB (>= '
                                 f'{MIN_SNR_DB}), max err {err:.3e} (<= '
                                 f'{bound:.3e})')
        worst, max_err = min(worst, snr), max(max_err, err)
    return worst, max_err


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
    from brever_tpu_torch.profile_train import make_trainer
    from brever_tpu_torch.serve import EnhanceService
    out = {}
    # cuFFT makes its plans with its own device allocations, which fail
    # (CUFFT_INTERNAL_ERROR) when PyTorch's allocator holds the card's
    # memory in its cache: hand the cache back between the large phases
    torch.cuda.empty_cache()

    # ---- phase 10: K3 and K4 vs their plain versions on the card
    rng = np.random.RandomState(10)
    cases = [LSTM_INTRA, LSTM_INTER, (7, 2, 1000, 72, 128), (1, 1, 33, 128, 128)]
    fwd_err, bwd_worst, bwd_err = 0.0, float('inf'), 0.0
    for n, case in enumerate(cases):
        name = 'T={} D={} R={} E={} H={}'.format(*case)
        x, w_ih, bias, w_hh, dh = lstm_inputs(rng, *case)
        if n == 2:  # weights at an unaligned offset, as in a flat buffer
            w_ih, w_hh = offset_view(w_ih), offset_view(w_hh)
        h, c = lstm.lstm_scan_x_fwd(x, w_ih, bias, w_hh)
        ref = lstm.lstm_scan_x_reference(x, w_ih, bias, w_hh)
        torch.cuda.synchronize()
        fwd_err = max(fwd_err, check_tensors(f'K3 {name}', ('h', 'c'), ref,
                                             (h, c))[1])
        del ref
        grads = lstm.lstm_scan_x_bwd(x, w_ih, bias, w_hh, h, c, dh)
        again = lstm.lstm_scan_x_bwd(x, w_ih, bias, w_hh, h, c, dh)
        f64 = [t.double() for t in (x, w_ih, bias, w_hh)]
        h64, c64 = lstm.lstm_scan_x_reference(*f64)
        ref = lstm.lstm_scan_x_bwd_plain(*f64, h64, c64, dh.double())
        del f64, h64, c64
        torch.cuda.synchronize()
        worst, err = check_tensors(f'K4 {name}', LSTM_NAMES, ref, grads)
        if not all(torch.equal(a, b) for a, b in zip(grads, again)):
            raise AssertionError(f'K4 {name}: two runs differ')
        bwd_worst, bwd_err = min(bwd_worst, worst), max(bwd_err, err)
        del ref, grads, again
    out['k3_err'], out['k4_err'] = fwd_err, bwd_err
    torch.cuda.empty_cache()
    phase(10, f'{len(cases)} scan cases (intra {LSTM_INTRA}, inter '
          f'{LSTM_INTER}, R=1000 E=72 with unaligned weights, T=1 D=1): '
          f'K3 h and c agree with the plain version (max abs err '
          f'{fwd_err:.3e}); K4 dx, dW_ih, db, '
          f'dW_hh with the plain backward in float64 (worst SNR '
          f'{bwd_worst:.1f} dB >= {MIN_SNR_DB}, max abs err {bwd_err:.3e}, '
          f'each <= {MAX_REL_ERR} x max|ref|); two runs bitwise equal')

    # ---- phase 11: enhance on the card vs the plain path in float64
    grid = ModelRegistry.get('tfgridnet')(device='cpu')
    grid.init_parameters(11)
    params = grid.to_flax(grid.state_dict())
    del grid
    gpu = EnhanceService.from_params('tfgridnet', {}, params, device)
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

    # ---- phase 13: training through BreverTrainer on the card
    epochs = 12
    with tempfile.TemporaryDirectory() as tmp:
        trainer = tone_trainers(tmp, 'tfgridnet', device, 20, 4)
        first = trainer(epochs)
        lstm.lstm_scan_x.launches = lstm.lstm_scan_x_bwd.launches = 0
        t0 = time.perf_counter()
        first.run()
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        out['launches_train'] = lstm.lstm_scan_x.launches
        out['launches_train_bwd'] = lstm.lstm_scan_x_bwd.launches
        if not out['launches_train'] or not out['launches_train_bwd']:
            raise AssertionError('training launched K3 {} and K4 {} times'
                                 .format(out['launches_train'],
                                         out['launches_train_bwd']))
        losses = first.loss_logger.train_loss
        last = float(np.mean(losses[-3:]))
        if not np.isfinite(losses).all() or last > GRID_LOSS_RATIO * losses[0]:
            raise AssertionError(f'training loss {losses[0]:.4f} -> '
                                 f'{last:.4f}')
        second = trainer(epochs + 2)
        second.init_state()
        second.load_checkpoint()
        if not torch.equal(second.flat, first.flat) \
                or not torch.equal(second.optimizer.nu, first.optimizer.nu) \
                or second.optimizer.learning_rate \
                != first.optimizer.learning_rate \
                or second.epochs_ran != epochs:
            raise AssertionError('resume did not restore the state')
        second.run()
        if second.epochs_ran != epochs + 2:
            raise AssertionError(f'resumed run ended at epoch '
                                 f'{second.epochs_ran}')
        trained = load_checkpoint(first.last_ckpt_path)['params']
        served = grid_model(trained, device)
        item = second.val_dataset[0][0][None]
        torch.testing.assert_close(served.enhance(item),
                                   second.model.enhance(item), atol=1e-6,
                                   rtol=1e-5)
        metrics = [m for m in first.loss_logger.metrics if m][-1]
        phase(13, f'TF-GridNet BreverTrainer, 24 x 1 s tone-in-noise WAV '
              f'items, batch 8, {epochs} epochs in {train_s:.1f} s: train '
              f'loss {losses[0]:.4f} -> {last:.4f} (multiresyu; <= '
              f'{GRID_LOSS_RATIO} x the first), val snr {metrics["snr"]:.2f}'
              f' sisnr {metrics["sisnr"]:.2f} dB; K3 '
              f'{out["launches_train"]} / K4 {out["launches_train_bwd"]} '
              f'launches; resumed bitwise (lr '
              f'{second.optimizer.learning_rate:g}) from last.ckpt to epoch '
              f'{second.epochs_ran}; the checkpoint serves')

        # ---- phase 14: the HTTP service over the model directory
        service = EnhanceService.from_params('tfgridnet', {}, trained,
                                             device)
        results = []
        lstm.lstm_scan_x.launches = 0
        with http_service(service) as (port, health):
            if health['params'] != GRID_PARAMS \
                    or health['arch'] != 'tfgridnet':
                raise AssertionError(f'/health: {health}')
            with plain_lstms():
                ref_model = grid_model(trained, device, torch.float64)
            for seconds in (0.05, 4):
                audio = (0.1 * np.random.RandomState(14).randn(
                    int(seconds * FS))).astype(np.float32)
                before = lstm.lstm_scan_x.launches
                got = post_wav(port, audio)
                launched = lstm.lstm_scan_x.launches - before
                with plain_lstms():
                    want = ref_model.enhance(np.stack([audio, audio]))
                snr, _ = check_output(f'TF-GridNet /enhance {seconds} s',
                                      want.cpu().numpy(), got)
                if launched != 12:
                    raise AssertionError(f'/enhance {seconds} s: {launched}'
                                         ' K3 launches, not 12')
                results.append(f'{seconds} s {snr:.1f} dB')
        out['launches_http'] = lstm.lstm_scan_x.launches
        phase(14, f'TF-GridNet /health ok, /enhance {", ".join(results)} '
              f'from the trained last.ckpt vs the plain path in float64; '
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
        timing[label] = {'fwd': fwd, 'bwd': bwd}
        del x, w_ih, bias, w_hh, dh, h, c
    batch = torch.from_numpy((0.1 * np.random.RandomState(16).randn(
        16, 2, 4 * FS)).astype(np.float32)).to(device)

    def plain_enhance():
        with plain_lstms():
            gpu.model.enhance(batch)

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
    phase(15, f'[{card}] BLSTM 16x4 s kernel/plain ms: intra K3 '
          f'{timing["intra"]["fwd"]["kernel"]:.3f}/'
          f'{timing["intra"]["fwd"]["plain"]:.3f} K4 '
          f'{timing["intra"]["bwd"]["kernel"]:.3f}/'
          f'{timing["intra"]["bwd"]["plain"]:.3f}, inter K3 '
          f'{timing["inter"]["fwd"]["kernel"]:.3f}/'
          f'{timing["inter"]["fwd"]["plain"]:.3f} K4 '
          f'{timing["inter"]["bwd"]["kernel"]:.3f}/'
          f'{timing["inter"]["bwd"]["plain"]:.3f}; TF-GridNet enhance 16x4 s '
          f'{enhance_ms["kernel"]:.2f} ms, peak '
          f'{enhance_peak["kernel"] / mib:.1f} MiB (plain LSTMs '
          f'{enhance_ms["plain"]:.2f} ms, {enhance_peak["plain"] / mib:.1f} '
          f'MiB); train step 16x4 s f32 {step_ms["kernel"]:.2f} ms, peak '
          f'{step_peak["kernel"] / mib:.1f} MiB (plain LSTMs '
          f'{step_ms["plain"]:.2f} ms, {step_peak["plain"] / mib:.1f} MiB)')
    return out


def main():
    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke: torch.cuda.is_available() is False; '
                         'this script needs a CUDA device')
    from brever_tpu_torch.checkpoint import load_checkpoint
    from brever_tpu_torch.models import count_params
    from brever_tpu_torch.models.base import sample_weighted_mean
    import brever_tpu_torch.models.convtasnet as convtasnet
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
    for name in ('yaml', 'msgpack'):
        try:
            __import__(name)
            optional.append(f'{name} importable')
        except ImportError:
            optional.append(f'{name} missing')
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
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
    max_err = 0.0
    with torch.inference_mode():
        for batch, t_total, dilation, last in cases:
            x, params = block_inputs(rng, batch, t_total)
            res, skip = tcn.tcn_block(x, params, dilation, last)
            ref_res, ref_skip = tcn.tcn_block_plain(x, params, dilation,
                                                    last)
            torch.cuda.synchronize()
            pairs = [(skip, ref_skip)] + ([] if last else [(res, ref_res)])
            if last and res is not None:
                raise AssertionError('last block returned a residual')
            for got, want in pairs:
                torch.testing.assert_close(got, want, atol=KERNEL_ATOL,
                                           rtol=KERNEL_RTOL)
                max_err = max(max_err, (got - want).abs().max().item())
    phase(2, f'{len(cases)} block cases (T 3999 d 1..128 last both ways, '
          f'T 49 d 64/128, T 520 d 600) agree with the plain version: max '
          f'abs err {max_err:.3e} (atol {KERNEL_ATOL}, rtol {KERNEL_RTOL}: '
          'f32 both, other summation order over ~2M elements a row)')

    # ---- phase 3: the full model on the card vs the plain CPU path
    flax_params = random_flax_params(np.random.RandomState(1), **DEFAULT)
    gpu = EnhanceService.from_params('convtasnet', {}, flax_params, device)
    cpu = EnhanceService.from_params('convtasnet', {}, flax_params, 'cpu')
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
    phase(5, f'[{card}] block B=16 T=3999 kernel/plain ms: d=1 '
          f'{timing[1]["kernel"]:.3f}/{timing[1]["plain"]:.3f}, d=128 '
          f'{timing[128]["kernel"]:.3f}/{timing[128]["plain"]:.3f}; enhance '
          f'16x4 s {model_ms["kernel"]:.2f} ms (plain blocks '
          f'{model_ms["plain"]:.2f} ms), {audio_rate:.1f} audio s/s, peak '
          f'{peak / 2 ** 20:.1f} MiB')

    # ---- phase 6: backward kernel vs plain version on the card
    rng = np.random.RandomState(6)
    bwd_worst, bwd_err, stats_err = float('inf'), 0.0, 0.0
    for batch, t_total, dilation, last in cases:
        x, params = block_inputs(rng, batch, t_total)
        if last:
            params = params[:10] + (None, None) + params[12:]
        g_res = None if last else torch.from_numpy(
            rng.randn(batch, t_total, 128).astype(np.float32)).to(device)
        g_skip = torch.from_numpy(
            rng.randn(batch, t_total, 128).astype(np.float32)).to(device)
        with torch.no_grad():
            (_, _, stats), act = tcn._launch(x, params, dilation, last)
            _, _, ref_stats = tcn.tcn_block_fwd_plain(x, params, dilation,
                                                      last)
        torch.testing.assert_close(stats, ref_stats, atol=1e-6, rtol=1e-5)
        stats_err = max(stats_err, ((stats - ref_stats).abs()
                                    / ref_stats.abs()).max().item())
        dx, dparams = tcn.tcn_block_bwd(x, params, stats, g_res, g_skip,
                                        dilation, last)
        ref = block_vjp_f64(x, params, g_res, g_skip, dilation, last, act)
        del act
        torch.cuda.synchronize()
        name = f'K2 B={batch} T={t_total} d={dilation} last={last}'
        worst, err = check_grads(name, ref, (dx,) + dparams)
        again = tcn.tcn_block_bwd(x, params, stats, g_res, g_skip, dilation,
                                  last)
        for got, rerun in zip((dx,) + dparams, (again[0],) + again[1]):
            if got is not None and not torch.equal(got, rerun):
                raise AssertionError(f'{name}: two runs differ')
        bwd_worst, bwd_err = min(bwd_worst, worst), max(bwd_err, err)
    phase(6, f'{len(cases)} block cases: K2 dx and every parameter gradient '
          f'agree with the plain block in float64 on K1\'s PReLU branches '
          f'(worst SNR {bwd_worst:.1f} dB >= {MIN_SNR_DB}, max abs err '
          f'{bwd_err:.3e}, each <= {MAX_REL_ERR} x max|ref|); two runs '
          f'bitwise equal; K1 stats within {stats_err:.1e} relative of the '
          f'plain ones (rtol 1e-5, atol 1e-6)')

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

    # ---- phase 8: training through BreverTrainer on the card
    epochs = 24
    with tempfile.TemporaryDirectory() as tmp:
        trainer = tone_trainers(tmp, 'convtasnet', device, 10, 6)
        first = trainer(epochs)
        tcn.tcn_block.launches = tcn.tcn_block_bwd.launches = 0
        t0 = time.perf_counter()
        first.run()
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        launches_train = tcn.tcn_block.launches
        launches_train_bwd = tcn.tcn_block_bwd.launches
        if launches_train == 0 or launches_train_bwd == 0:
            raise AssertionError(f'training launched K1 {launches_train} '
                                 f'and K2 {launches_train_bwd} times')
        losses = first.loss_logger.train_loss
        drop = losses[0] - float(np.mean(losses[-3:]))
        if not np.isfinite(losses).all() or drop <= 1.0:
            raise AssertionError(f'training loss {losses[0]:.2f} -> '
                                 f'{np.mean(losses[-3:]):.2f} dB')
        ckpt = first.last_ckpt_path
        if not os.path.exists(ckpt):
            raise AssertionError('no last.ckpt')
        second = trainer(epochs + 2)
        second.init_state()
        second.load_checkpoint()
        if not torch.equal(second.flat, first.flat) \
                or second.epochs_ran != epochs:
            raise AssertionError('resume did not restore the parameters')
        second.run()
        if second.epochs_ran != epochs + 2 \
                or len(second.loss_logger.train_loss) != epochs + 2:
            raise AssertionError(f'resumed run ended at epoch '
                                 f'{second.epochs_ran}')
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
    phase(8, f'BreverTrainer, 24 x 1 s tone-in-noise WAV items, batch 8, '
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
          f'clip, Adam) {step_ms["kernel"]:.2f} ms, peak '
          f'{step_peak["kernel"] / 2 ** 20:.1f} MiB (plain blocks '
          f'{step_ms["plain"]:.2f} ms, peak '
          f'{step_peak["plain"] / 2 ** 20:.1f} MiB)')

    grid = tfgridnet_phases(device, card)

    if any(m in sys.modules for m in ('jax', 'flax', 'optax',
                                      'brever_tpu')):
        raise AssertionError('the port pulled in JAX or the JAX package')
    shape = 'B=16 T=3999 C=128 H=512 Cs=128'
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
        'shape': shape,
        'train_step_ms': step_ms['kernel'],
        'train_step_plain_ms': step_ms['plain'],
    }, {
        'name': 'lstm_scan_x_fwd',
        'route': 'cuda',
        'source': 'brever_tpu_torch/csrc/lstm_scan.cu',
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
        'shape': 'intra T=33 D=2 R=8064 E=H=128; inter T=126 R=2112',
        'enhance_16x4s_ms': grid['enhance_ms']['kernel'],
        'enhance_16x4s_plain_ms': grid['enhance_ms']['plain'],
    }, {
        'name': 'lstm_scan_x_bwd',
        'route': 'cuda',
        'source': 'brever_tpu_torch/csrc/lstm_scan.cu',
        'replaces': 'brever_tpu/ops/pallas/lstm_scan.py:503',
        'launches': grid['launches_train_bwd'],
        'max_abs_err': grid['k4_err'],
        'ms': grid['timing']['intra']['bwd']['kernel'],
        'plain_ms': grid['timing']['intra']['bwd']['plain'],
        'ms_inter': grid['timing']['inter']['bwd']['kernel'],
        'plain_ms_inter': grid['timing']['inter']['bwd']['plain'],
        'shape': 'intra T=33 D=2 R=8064 E=H=128; inter T=126 R=2112',
        'train_step_ms': grid['step_ms']['kernel'],
        'train_step_plain_ms': grid['step_ms']['plain'],
    }]}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    main()
