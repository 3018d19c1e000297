"""Smoke run of the PyTorch/CUDA port (brever_tpu_torch) on one GPU.

Drives the port's serving path for full-width non-causal Conv-TasNet
(filters 512, bottleneck 128, hidden 512, skip 128, 8 layers x 3
repeats; 4,935,217 random parameters from a numpy seed) on the card, in
phases that each print one line:

0. the card (nvidia-smi name and power limit), versions, optional deps;
1. build the CUDA kernels from brever_tpu_torch/csrc with nvcc;
2. the TCN block kernel against its plain PyTorch version on the card;
3. the full model's enhance on the card against the plain path on a
   CPU copy;
4. the HTTP service (/health, three /enhance requests) on the card;
5. timings: per-block kernel vs plain version, full enhance.

Float32 throughout, with TF32 off for cuDNN and cuBLAS so that the
comparisons hold the kernels to float32. Any failure raises (non-zero
exit). The line before the last is a JSON record of each kernel, the
last line ``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py
"""

import http.client
import io
import json
import platform
import subprocess
import sys
import threading
import time

import numpy as np
import torch

#: kernel vs plain version on the card: both float32, but the kernel
#: sums the GEMMs in another order and merges the gLN moments of ~2M
#: elements a row per tile, so agreement is to rounding, not bitwise
KERNEL_ATOL, KERNEL_RTOL = 1e-4, 1e-3
#: full model on the card vs the plain path on the CPU
MIN_SNR_DB, MAX_REL_ERR = 60.0, 1e-3

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


def main():
    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke: torch.cuda.is_available() is False; '
                         'this script needs a CUDA device')
    from brever_tpu_torch.models import count_params
    import brever_tpu_torch.models.convtasnet as convtasnet
    from brever_tpu_torch.ops import build
    from brever_tpu_torch.ops import tcn_block as tcn
    from brever_tpu_torch.serve import EnhanceService, make_http_server

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

    if any(m in sys.modules for m in ('jax', 'flax', 'optax',
                                      'brever_tpu')):
        raise AssertionError('the port pulled in JAX or the JAX package')
    print(json.dumps({'kernels': [{
        'name': 'tcn_block_fwd',
        'route': 'cuda',
        'source': 'brever_tpu_torch/csrc/tcn_block.cu',
        'replaces': 'brever_tpu/ops/pallas/tcn_block.py:481',
        'launches': launches,
        'max_abs_err': max_err,
        'ms': timing[1]['kernel'],
        'plain_ms': timing[1]['plain'],
        'ms_d128': timing[128]['kernel'],
        'plain_ms_d128': timing[128]['plain'],
        'shape': 'B=16 T=3999 C=128 H=512 Cs=128',
    }]}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    main()
