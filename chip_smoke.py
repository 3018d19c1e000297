"""Smoke run of the PyTorch/CUDA port (brever_tpu_torch) on one GPU.

Drives the port's serving and training paths for full-width non-causal
Conv-TasNet (filters 512, bottleneck 128, hidden 512, skip 128, 8 layers
x 3 repeats; 4,935,217 random parameters from a numpy seed) on the card,
in phases that each print one line:

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
   step with kernel and with plain blocks, peak memory.

Float32 throughout, with TF32 off for cuDNN and cuBLAS so that the
comparisons hold the kernels to float32. Any failure raises (non-zero
exit). The line before the last is a JSON record of each kernel, the
last line ``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py
"""

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


def main():
    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke: torch.cuda.is_available() is False; '
                         'this script needs a CUDA device')
    from brever_tpu_torch.checkpoint import load_checkpoint
    from brever_tpu_torch.data import BreverDataset
    from brever_tpu_torch.models import ModelRegistry, count_params
    from brever_tpu_torch.models.base import sample_weighted_mean
    import brever_tpu_torch.models.convtasnet as convtasnet
    from brever_tpu_torch.ops import build
    from brever_tpu_torch.ops import tcn_block as tcn
    from brever_tpu_torch.profile_train import make_trainer
    from brever_tpu_torch.serve import (EnhanceService, build_model,
                                        make_http_server)
    from brever_tpu_torch.training import BreverTrainer

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
    server = make_http_server(gpu, '127.0.0.1', 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    results = []
    try:
        port = server.server_address[1]
        conn = http.client.HTTPConnection('127.0.0.1', port, timeout=60)
        conn.request('GET', '/health')
        health = json.loads(conn.getresponse().read())
        conn.close()
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
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    if thread.is_alive():
        raise AssertionError('server thread did not stop')
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
        for split, n_items, seed in (('train', 24, 10), ('val', 4, 11)):
            write_tone_dataset(os.path.join(tmp, split), n_items, 1.0, seed)
        model_dir = os.path.join(tmp, 'model')
        options = dict(device=str(device), batch_sampler='random',
                       batch_size=8, dynamic_batch_size=False,
                       val_metrics={'snr', 'sisnr'}, val_period=6, seed=0)

        def trainer(n_epochs):
            return BreverTrainer(
                ModelRegistry.get('convtasnet')(device='cpu'),
                BreverDataset(os.path.join(tmp, 'train')),
                BreverDataset(os.path.join(tmp, 'val')), model_dir,
                epochs=n_epochs, **options)

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
        ckpt = os.path.join(model_dir, 'checkpoints', 'last.ckpt')
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
    }]}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    main()
