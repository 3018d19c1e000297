"""Repeat the gradient comparison of a small Conv-TasNet off 3 taps (the card
test ``test_kernel_size_off_three_serves_and_trains_on_the_card``) and say
where its error comes from; the test takes its bounds from here.

One run builds the test's model (``SMALL`` widths, ``--kernel-size`` taps,
plain blocks on every device; drawn from ``--seed``, or unseeded as the
test drew it before) on the CPU and on the card, takes the snr loss's
gradients of the test's batch on the card (twice), in float32 on the CPU
and in float64 on the CPU, and prints one JSON line:

* ``old``: the worst tensor of the old check, card against CPU float32,
  ``max |g - c| / (1e-4 max|c| + 1e-3 |c|)`` (above 1 fails);
* ``new``: the worst tensor of the check against float64,
  ``max |g - r| / bound`` with the bounds of :func:`gradient_bounds`
  (above 1 fails), and beside it the card's and the CPU float32 path's own
  errors;
* ``flips``: PReLU inputs whose sign differs between the card's forward and
  the float64 one (a flipped branch changes a gradient by ``1 - alpha``
  times its cotangent);
* ``rerun_bitwise``: whether the second gradient on the card equals the
  first bit for bit, and ``digest``, a hash of the card's gradients, to
  compare across processes (runs with other algorithm choices);
* ``kernels``: the names of the card's kernels in one backward, from a
  ``torch.profiler`` trace (cuDNN's algorithm shows in them).

    python -m brever_tpu_torch.probe_conv_grads [--kernel-size 2]
        [--device cuda]
"""

import argparse
import hashlib
import json

import numpy as np
import torch

from .models import ModelRegistry, common
from .models.base import sample_weighted_mean
from .numerics import disable_tf32
from .ops import functional, tcn_block

SMALL = dict(filters=64, filter_length=16, bottleneck_channels=32,
             hidden_channels=64, skip_channels=32, layers=2, repeats=2)


def gradient_bounds(ref, plain, scales, factor=8.0, floor=1e-5):
    """The bound of each float32 gradient against its float64 reference
    ``ref`` (name -> tensor): ``factor`` times the error of the plain
    float32 path ``plain`` on the CPU, at least ``floor`` of the tensor's
    condition scale (``scales``: a PReLU slope's sum of its terms'
    magnitudes, where its gradient cancels; else the tensor's largest
    value)."""
    return {name: max(factor * (plain[name] - r).abs().max().item(),
                      floor * scales.get(name, r.abs().max().item()))
            for name, r in ref.items()}


def batch_of(kernel_size):
    """The test's inputs: the enhance input, then a (2, 2, 2, 2400) batch
    and its lengths."""
    rng = np.random.RandomState(kernel_size)
    x = rng.randn(2, 2, 4000).astype(np.float32)
    target = 0.3 * rng.randn(2, 1, 2, 2400)
    batch = np.concatenate([target + 0.3 * rng.randn(2, 1, 2, 2400), target],
                           axis=1).astype(np.float32)
    return x, batch, np.array([2400, 1700], np.int32)


def grads(model, batch, lengths, record=None):
    """The snr loss's gradients of every parameter (name -> float64 CPU
    tensor); ``record`` collects each PReLU's input and output, in call
    order (the blocks', then ``prelu_out``'s), the outputs keeping their
    gradients."""
    original = functional.prelu

    def prelu(x, alpha):
        out = original(x, alpha)
        if record is not None:
            out.retain_grad()
            record.append((x, out))
        return out

    dev = next(model.parameters()).device
    dtype = next(model.parameters()).dtype
    n = torch.from_numpy(lengths).to(dev)
    model.zero_grad()
    tcn_block.prelu = common.prelu = prelu
    try:
        sample_weighted_mean(
            model.loss(torch.from_numpy(batch).to(dev, dtype), n),
            n).backward()
    finally:
        tcn_block.prelu = common.prelu = original
    return {name: p.grad.detach().double().cpu()
            for name, p in model.named_parameters()}


def reference(model, batch, lengths):
    """The float64 gradients of a float64 CPU model, each PReLU slope's
    condition scale (the sum of its gradient's terms' magnitudes,
    ``sum |dL/dh min(z, 0)|``) and the PReLU inputs."""
    record = []
    ref = grads(model, batch, lengths, record)
    names = [f'tcn.blocks.{i // 2}.prelu_{i % 2 + 1}.alpha'
             for i in range(len(record) - 1)] + ['tcn.prelu_out.alpha']
    scales = {name: (h.grad * z.detach().clamp(max=0)).abs().sum().item()
              for name, (z, h) in zip(names, record)}
    return ref, scales, [z.detach() for z, _ in record]


def seeded_models(kernel_size, device, seed=0):
    """The test's model, drawn from ``seed``, on the CPU in float32 and in
    float64 and on ``device``."""
    kwargs = dict(SMALL, kernel_size=kernel_size)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        cpu = ModelRegistry.get('convtasnet')(**kwargs, device='cpu')
    f64 = ModelRegistry.get('convtasnet')(**kwargs, device='cpu').double()
    f64.load_state_dict(cpu.state_dict())
    gpu = ModelRegistry.get('convtasnet')(**kwargs, device=device)
    gpu.load_state_dict(cpu.state_dict())
    return cpu, f64, gpu


def run(kernel_size, device, seed=None):
    """One comparison; ``seed`` None draws the model unseeded (the old
    test's draw, another model each process)."""
    disable_tf32()
    if seed is None:
        seed = int(torch.seed() % 2 ** 31)
    cpu, f64, gpu = seeded_models(kernel_size, device, seed)
    _, batch, lengths = batch_of(kernel_size)
    rec_gpu = []
    g = grads(gpu, batch, lengths, rec_gpu)
    again = grads(gpu, batch, lengths)
    c = grads(cpu, batch, lengths)
    r, scales, z_ref = reference(f64, batch, lengths)
    bounds = gradient_bounds(r, c, scales)
    old, new = {}, {}
    for name in r:
        old[name] = ((g[name] - c[name]).abs()
                     / (1e-4 * c[name].abs().max()
                        + 1e-3 * c[name].abs())).max().item()
        new[name] = {'ratio': (g[name] - r[name]).abs().max().item()
                     / bounds[name],
                     'card_err': (g[name] - r[name]).abs().max().item(),
                     'plain_err': (c[name] - r[name]).abs().max().item()}
    flips = sum(int(((z.detach().double().cpu() >= 0) != (zr >= 0)).sum())
                for (z, _), zr in zip(rec_gpu, z_ref))
    kernels = []
    if device.type == 'cuda':
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            grads(gpu, batch, lengths)
            torch.cuda.synchronize()
        kernels = sorted({e.key for e in prof.key_averages()
                          if e.device_type == torch.autograd.DeviceType.CUDA})
    worst_old = max(old, key=old.get)
    worst_new = max(new, key=lambda k: new[k]['ratio'])
    digest = hashlib.sha1(b''.join(g[k].numpy().tobytes() for k in g))
    return {
        'kernel_size': kernel_size,
        'seed': seed,
        'old': {'worst': worst_old, 'ratio': old[worst_old],
                'encoder.weight': old['encoder.weight']},
        'new': {'worst': worst_new, **new[worst_new],
                'encoder.weight': new['encoder.weight']},
        'flips': flips,
        'rerun_bitwise': all(torch.equal(g[k], again[k]) for k in g),
        'digest': digest.hexdigest()[:16],
        'cudnn': {'deterministic': torch.backends.cudnn.deterministic,
                  'benchmark': torch.backends.cudnn.benchmark,
                  'version': torch.backends.cudnn.version()},
        'kernels': kernels,
    }


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('--kernel-size', type=int, default=2)
    parser.add_argument('--device', default='cuda')
    parser.add_argument('--seed', type=int, default=None,
                        help='the model\'s seed (default: unseeded)')
    args = parser.parse_args()
    print(json.dumps(run(args.kernel_size, torch.device(args.device),
                         args.seed)), flush=True)


if __name__ == '__main__':
    main()
