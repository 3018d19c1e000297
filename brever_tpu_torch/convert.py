"""Weight bridge between the JAX package's flax parameter trees and the
port's ``state_dict``, for Conv-TasNet and TF-GridNet.

A flax ``params`` tree is a nested dict of numpy arrays, as
``brever_tpu.checkpoint.load_checkpoint`` returns it. The rules:

* encoder ``Conv`` kernel ``(L, 1, F)`` -> ``conv1d`` weight ``(F, 1, L)``;
* decoder ``ConvTranspose`` kernel ``(L, F, 1)`` (flax,
  ``transpose_kernel=False``) -> ``conv_transpose1d`` weight
  ``(F, 1, L)`` flipped in time;
* Dense ``(in, out)`` -> Linear ``(out, in)``;
* depthwise kernel ``(k, 1, H)`` -> taps ``(k, H)``;
* the scanned sweeps ``tcn/sweeps/block_i`` carry a leading repeat axis
  of length ``repeats - 1``: repeat ``r``, block ``i`` is TCN block
  ``r * layers + i``; ``tcn/block_last_i`` follow, the final one without
  ``res``;
* gLN scopes are ``GlobalLayerNorm_0``/``_1`` inside a block and
  ``tcn/GlobalLayerNorm_0`` before the bottleneck.

TF-GridNet (``tfgridnet_*``):

* ``Conv`` kernels ``(kh, kw, in, out)`` -> ``conv2d`` weights
  ``(out, in, kh, kw)``; the ``deconv`` is flax's stride-1
  ``ConvTranspose`` with ``transpose_kernel=False`` and padding 1, which is
  that same correlation, so its kernel maps unflipped (a torch
  ``conv_transpose2d`` would need it flipped in both axes);
* the grid blocks live under one scanned scope ``blocks/block`` with a
  leading axis of ``n_layers``: block ``i`` is ``blocks.{i}``;
* Dense scopes map as above; every other scope (norms, BLSTMs, PReLUs)
  keeps its leaf names and shapes.
"""

import numpy as np
import torch


def _f32(a):
    return np.asarray(a, dtype=np.float32)


def _dense_to_torch(prefix, tree):
    return {f'{prefix}.weight': _f32(tree['kernel']).T,
            f'{prefix}.bias': _f32(tree['bias'])}


def _dense_to_flax(sd, prefix):
    return {'kernel': sd[f'{prefix}.weight'].T, 'bias': sd[f'{prefix}.bias']}


def _norm_to_torch(prefix, tree):
    return {f'{prefix}.scale': _f32(tree['scale']),
            f'{prefix}.bias': _f32(tree['bias'])}


def _norm_to_flax(sd, prefix):
    return {'scale': sd[f'{prefix}.scale'], 'bias': sd[f'{prefix}.bias']}


def _block_to_torch(prefix, tree):
    kernel = _f32(tree['depthwise']['kernel'])
    out = {
        **_dense_to_torch(f'{prefix}.conv_in', tree['conv_in']),
        f'{prefix}.prelu_1.alpha': _f32(tree['prelu_1']['alpha']),
        **_norm_to_torch(f'{prefix}.norm_1', tree['GlobalLayerNorm_0']),
        f'{prefix}.depthwise.weight': kernel.reshape(kernel.shape[0], -1),
        f'{prefix}.depthwise.bias': _f32(tree['depthwise']['bias']),
        f'{prefix}.prelu_2.alpha': _f32(tree['prelu_2']['alpha']),
        **_norm_to_torch(f'{prefix}.norm_2', tree['GlobalLayerNorm_1']),
        **_dense_to_torch(f'{prefix}.skip', tree['skip']),
    }
    if 'res' in tree:
        out.update(_dense_to_torch(f'{prefix}.res', tree['res']))
    return out


def _block_to_flax(sd, prefix):
    weight = sd[f'{prefix}.depthwise.weight']
    out = {
        'conv_in': _dense_to_flax(sd, f'{prefix}.conv_in'),
        'prelu_1': {'alpha': sd[f'{prefix}.prelu_1.alpha']},
        'GlobalLayerNorm_0': _norm_to_flax(sd, f'{prefix}.norm_1'),
        'depthwise': {'kernel': weight.reshape(weight.shape[0], 1, -1),
                      'bias': sd[f'{prefix}.depthwise.bias']},
        'prelu_2': {'alpha': sd[f'{prefix}.prelu_2.alpha']},
        'GlobalLayerNorm_1': _norm_to_flax(sd, f'{prefix}.norm_2'),
        'skip': _dense_to_flax(sd, f'{prefix}.skip'),
    }
    if f'{prefix}.res.weight' in sd:
        out['res'] = _dense_to_flax(sd, f'{prefix}.res')
    return out


def _map(fn, tree):
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _stack(trees):
    first = trees[0]
    return {k: _stack([t[k] for t in trees]) if isinstance(first[k], dict)
            else np.stack([t[k] for t in trees]) for k in first}


def flax_to_state_dict(params):
    """Flax ``params`` tree of ``ConvTasNet`` -> the port's
    ``state_dict`` (float32 CPU tensors)."""
    tcn = params['tcn']
    layers = sum(k.startswith('block_last_') for k in tcn)
    blocks = []
    if 'sweeps' in tcn:
        sweeps = tcn['sweeps']
        n_sweeps = _f32(sweeps['block_0']['skip']['bias']).shape[0]
        for r in range(n_sweeps):
            blocks += [_map(lambda a: _f32(a)[r], sweeps[f'block_{i}'])
                       for i in range(layers)]
    blocks += [tcn[f'block_last_{i}'] for i in range(layers)]

    encoder = _f32(params['encoder']['kernel'])          # (L, 1, F)
    decoder = _f32(params['decoder']['kernel'])          # (L, F, 1)
    sd = {
        'encoder.weight': encoder.transpose(2, 1, 0),
        'decoder.weight': decoder.transpose(1, 2, 0)[:, :, ::-1],
        **_norm_to_torch('tcn.norm', tcn['GlobalLayerNorm_0']),
        **_dense_to_torch('tcn.bottleneck', tcn['bottleneck']),
        'tcn.prelu_out.alpha': _f32(tcn['prelu_out']['alpha']),
        **_dense_to_torch('tcn.mask', tcn['mask']),
    }
    for j, block in enumerate(blocks):
        sd.update(_block_to_torch(f'tcn.blocks.{j}', block))
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def state_dict_to_flax(state_dict, layers):
    """The port's ``state_dict`` -> flax ``params`` tree (numpy), for a
    TCN of ``layers`` blocks per repeat."""
    sd = {k: v.detach().cpu().numpy() for k, v in state_dict.items()}
    n_blocks = sum(k.endswith('.conv_in.weight') for k in sd)
    repeats = n_blocks // layers
    blocks = [_block_to_flax(sd, f'tcn.blocks.{j}') for j in range(n_blocks)]
    tcn = {
        'GlobalLayerNorm_0': _norm_to_flax(sd, 'tcn.norm'),
        'bottleneck': _dense_to_flax(sd, 'tcn.bottleneck'),
        'prelu_out': {'alpha': sd['tcn.prelu_out.alpha']},
        'mask': _dense_to_flax(sd, 'tcn.mask'),
    }
    if repeats > 1:
        tcn['sweeps'] = {
            f'block_{i}': _stack([blocks[r * layers + i]
                                  for r in range(repeats - 1)])
            for i in range(layers)}
    for i in range(layers):
        tcn[f'block_last_{i}'] = blocks[(repeats - 1) * layers + i]
    return {
        'encoder': {'kernel': sd['encoder.weight'].transpose(2, 1, 0)},
        'decoder': {'kernel': sd['decoder.weight'][:, :, ::-1]
                    .transpose(2, 0, 1)},
        'tcn': tcn,
    }


# ---------------------------------------------------------------------------
# TF-GridNet

def _conv2d_to_torch(prefix, tree):
    return {f'{prefix}.weight': _f32(tree['kernel']).transpose(3, 2, 0, 1),
            f'{prefix}.bias': _f32(tree['bias'])}


def _conv2d_to_flax(sd, prefix):
    return {'kernel': sd[f'{prefix}.weight'].transpose(2, 3, 1, 0),
            'bias': sd[f'{prefix}.bias']}


def _scope_to_torch(prefix, tree):
    if 'kernel' in tree:
        return _dense_to_torch(prefix, tree)
    return {f'{prefix}.{k}': _f32(v) for k, v in tree.items()}


def tfgridnet_flax_to_state_dict(params):
    """Flax ``params`` tree of ``TFGridNet`` -> the port's ``state_dict``
    (float32 CPU tensors)."""
    sd = {**_conv2d_to_torch('embed', params['embed']),
          **_norm_to_torch('embed_norm', params['embed_norm']),
          **_conv2d_to_torch('deconv', params['deconv'])}
    block = params['blocks']['block']
    n_layers = _f32(block['intra_norm']['scale']).shape[0]
    for i in range(n_layers):
        for scope, tree in block.items():
            sd.update(_scope_to_torch(
                f'blocks.{i}.{scope}',
                {k: _f32(v)[i] for k, v in tree.items()}))
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def tfgridnet_state_dict_to_flax(state_dict):
    """The port's TF-GridNet ``state_dict`` -> flax ``params`` tree
    (numpy)."""
    sd = {k: v.detach().cpu().numpy() for k, v in state_dict.items()}
    n_layers = 1 + max(int(k.split('.')[1]) for k in sd
                       if k.startswith('blocks.'))
    scopes = {}
    for key, value in sd.items():
        if key.startswith('blocks.0.'):
            scope, leaf = key.split('.')[2:]
            scopes.setdefault(scope, []).append(leaf)
    block = {}
    for scope, leaves in scopes.items():
        trees = []
        for i in range(n_layers):
            prefix = f'blocks.{i}.{scope}'
            trees.append(_dense_to_flax(sd, prefix) if 'weight' in leaves
                         else {leaf: sd[f'{prefix}.{leaf}'] for leaf in leaves})
        block[scope] = _stack(trees)
    return {
        'embed': _conv2d_to_flax(sd, 'embed'),
        'embed_norm': _norm_to_flax(sd, 'embed_norm'),
        'blocks': {'block': block},
        'deconv': _conv2d_to_flax(sd, 'deconv'),
    }


# ---------------------------------------------------------------------------
# SGMSE+

def _flatten(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _nest(items):
    out = {}
    for path, value in items:
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value
    return out


def sgmse_flax_to_state_dict(params, aux=None):
    """Flax ``params`` tree of the diffusion U-Net, and its ``buffers``
    collection (``aux = {'buffers': ...}``, the Fourier frequencies of the
    noise embedding), -> the port's SGMSE+ ``state_dict`` (float32 CPU
    tensors, under ``net.``). Every scope keeps its name (a GroupNorm's
    affine under ``GroupNorm_0``); ``Conv`` kernels ``(kh, kw, in, out)``
    become ``conv2d`` weights ``(out, in, kh, kw)``, ``Dense`` kernels
    ``(in, out)`` ``Linear`` weights ``(out, in)``."""
    sd = {}
    for (*scope, leaf), value in _flatten(params):
        prefix, a = 'net.' + '.'.join(scope), _f32(value)
        if leaf == 'kernel':
            sd[f'{prefix}.weight'] = a.T if a.ndim == 2 \
                else a.transpose(3, 2, 0, 1)
        else:
            sd[f'{prefix}.{leaf}'] = a
    for path, value in _flatten((aux or {}).get('buffers', {})):
        sd['net.' + '.'.join(path)] = _f32(value)
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


#: the SGMSE+ state_dict's entries that are flax ``buffers``, not ``params``
_SGMSE_BUFFERS = ('net.emb.fourier_freqs',)


def sgmse_state_dict_to_flax(state_dict):
    """The port's SGMSE+ ``state_dict`` -> ``(params, aux)``, the flax
    ``params`` tree and ``{'buffers': ...}`` (numpy)."""
    params, aux = [], []
    for key, value in state_dict.items():
        a = value.detach().cpu().numpy()
        *scope, leaf = key.split('.')[1:]
        if key in _SGMSE_BUFFERS:
            aux.append((tuple(scope) + (leaf,), a))
        elif leaf == 'weight':
            params.append((tuple(scope) + ('kernel',), a.T if a.ndim == 2
                           else a.transpose(2, 3, 1, 0)))
        else:
            params.append((tuple(scope) + (leaf,), a))
    return _nest(params), {'buffers': _nest(aux)}
