"""The port's HTTP service (brever_tpu_torch.serve) on a model directory
that the JAX package wrote, and its checkpoint reader against the JAX
package's."""

import http.client
import io
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import yaml

from brever_tpu.audio import read_wav, write_wav
from brever_tpu.checkpoint import load_checkpoint as jax_load_checkpoint
from brever_tpu.checkpoint import save_checkpoint
from brever_tpu.models import ModelRegistry, count_params
from brever_tpu_torch import audio
from brever_tpu_torch.checkpoint import load_checkpoint
from brever_tpu_torch.serve import EnhanceService, make_server

TINY = dict(filters=32, filter_length=16, bottleneck_channels=16,
            hidden_channels=32, skip_channels=16, layers=2, repeats=2)


def _model_dir(tmp_path):
    model = ModelRegistry.get('convtasnet')(**TINY)
    variables = model.init_variables(jax.random.PRNGKey(0))
    model_dir = tmp_path / 'model'
    (model_dir / 'checkpoints').mkdir(parents=True)
    with open(model_dir / 'config.yaml', 'w') as f:
        yaml.dump({'arch': 'convtasnet', 'model': TINY}, f)
    save_checkpoint(model_dir / 'checkpoints' / 'last.ckpt',
                    {'params': variables['params'], 'aux': {}})
    return str(model_dir), model, variables


def test_serve_matches_jax(tmp_path):
    model_dir, model, variables = _model_dir(tmp_path)
    server, service = make_server(model_dir, device='cpu', port=0,
                                  warmup=False)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        conn = http.client.HTTPConnection('127.0.0.1',
                                          server.server_address[1],
                                          timeout=120)
        conn.request('GET', '/health')
        resp = conn.getresponse()
        health = json.loads(resp.read())
        assert resp.status == 200
        assert health['arch'] == 'convtasnet'
        assert health['params'] == count_params(variables)
        assert health['device'] == 'cpu'

        x = (np.random.RandomState(0).randn(4000) * 0.1).astype('float32')
        buf = io.BytesIO()
        write_wav(buf, x[:, None], 16000)
        conn.request('POST', '/enhance', body=buf.getvalue(),
                     headers={'Content-Type': 'audio/wav'})
        resp = conn.getresponse()
        assert resp.status == 200
        out, fs = read_wav(io.BytesIO(resp.read()), always_2d=True)
        assert fs == 16000 and out.shape == (4000, 1)
        # the JAX service's semantics: mono repeated to two channels
        ref = np.asarray(model.enhance(variables, np.stack([x, x])))
        np.testing.assert_allclose(out[:, 0], ref, atol=1e-4)

        conn.request('POST', '/enhance', body=b'not a wav')
        resp = conn.getresponse()
        assert resp.status == 400
        assert b'bad WAV payload' in resp.read()

        conn.request('POST', '/enhance_stream', body=b'\0' * 16)
        resp = conn.getresponse()
        assert resp.status == 400
        assert b'causal' in resp.read()

        conn.request('GET', '/nope')
        resp = conn.getresponse()
        resp.read()
        assert resp.status == 404
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()


def test_from_params_matches_model_dir(tmp_path):
    model_dir, _, variables = _model_dir(tmp_path)
    from_dir = EnhanceService(model_dir, device='cpu')
    params = jax.tree.map(np.asarray, variables['params'])
    in_memory = EnhanceService.from_params('convtasnet', TINY, params,
                                           device='cpu')
    x = np.random.RandomState(1).randn(1000, 2).astype('float32')
    np.testing.assert_array_equal(from_dir.enhance(x), in_memory.enhance(x))
    assert from_dir.health()['checkpoint'] == 'last.ckpt'


def test_checkpoint_reader_matches_flax(tmp_path):
    rng = np.random.RandomState(2)
    state = {
        'params': {'w': rng.randn(3, 4).astype('float32'),
                   'half': jnp.asarray(rng.randn(5), jnp.bfloat16),
                   'i': np.arange(6, dtype=np.int32).reshape(2, 3)},
        'step': np.int64(7),
        'lr': np.float32(1e-3),
        'epoch': 3,
        'name': 'convtasnet',
        'nested': {'empty': {}, 'flag': True, 'none': None},
    }
    path = tmp_path / 'state.ckpt'
    save_checkpoint(path, state)
    ref = jax_load_checkpoint(path)
    got = load_checkpoint(path)

    def compare(a, b):
        if isinstance(b, dict):
            assert isinstance(a, dict) and a.keys() == b.keys()
            for k in b:
                compare(a[k], b[k])
        elif isinstance(b, (np.ndarray, np.generic)):
            b32 = np.asarray(b).astype(np.float32) \
                if b.dtype.name == 'bfloat16' else np.asarray(b)
            assert np.asarray(a).dtype == b32.dtype
            np.testing.assert_array_equal(np.asarray(a), b32)
        else:
            assert type(a) is type(b) and a == b

    compare(got, ref)
    assert got['params']['half'].dtype == np.float32   # widened exactly


@pytest.mark.parametrize('subtype,channels', [('FLOAT', 1), ('FLOAT', 2),
                                              ('PCM_16', 1), ('PCM_16', 2)])
def test_wav_codec_matches_jax_package(subtype, channels):
    """The port's WAV codec reads what the JAX package's writes, and the
    JAX package reads what the port's writes."""
    data = (0.3 * np.random.RandomState(3).randn(500, channels)) \
        .astype('float32')
    buf = io.BytesIO()
    write_wav(buf, data, 16000, subtype=subtype)
    for always_2d in (False, True):
        got, fs = audio.read_wav(io.BytesIO(buf.getvalue()), always_2d)
        ref, ref_fs = read_wav(io.BytesIO(buf.getvalue()),
                               always_2d=always_2d)
        assert fs == ref_fs == 16000
        assert got.dtype == np.float32 and got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)

    out = io.BytesIO()
    audio.write_wav(out, data if channels > 1 else data[:, 0], 8000)
    assert out.getvalue()[:4] == b'RIFF'
    back, fs = read_wav(io.BytesIO(out.getvalue()), always_2d=True)
    assert fs == 8000
    np.testing.assert_array_equal(back, data)


@pytest.mark.parametrize('payload', [b'', b'not a wav', b'RIFF\0\0\0\0WAVE',
                                     b'RIFF\0\0\0\0WAVEdata\4\0\0\0abcd'])
def test_wav_codec_rejects_bad_payloads(payload):
    with pytest.raises(ValueError):
        audio.read_wav(io.BytesIO(payload))
