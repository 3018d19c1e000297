"""Serve a trained model over HTTP on a PyTorch device (counterpart of
``scripts/serve_model.py``).

Loads a model directory that the JAX package wrote (``config.yaml`` and
``checkpoints/*.ckpt``), builds the model on the given device and
answers

* ``GET /health`` — JSON: architecture, parameter count, sample rate,
  checkpoint, device;
* ``POST /enhance`` — body: a WAV file; response: the enhanced WAV
  (mono float32 at the model sample rate).

``POST /enhance_stream`` (causal streaming) answers 400: the port has no
streaming pipeline yet. Requests are serialized through one model.

    python -m brever_tpu_torch.serve <model_dir> [--device cuda]
        [--host 127.0.0.1] [--port 8000] [--best <metric>]
"""

import argparse
import io
import json
import os
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from .audio import read_wav, write_wav
from .checkpoint import load_checkpoint
from .models import ModelRegistry, count_params


def find_best_checkpoint(checkpoints_dir, metric):
    """The checkpoint whose file name records the highest ``metric``."""
    regex = rf'^.*?_{metric}=(\d+\.\d+(?:e(?:\+|-)\d+)?).*?\.ckpt$'
    candidates = []
    for filename in os.listdir(checkpoints_dir):
        match = re.match(regex, filename)
        if match:
            candidates.append(
                (os.path.join(checkpoints_dir, filename),
                 float(match.group(1))))
    if not candidates:
        raise FileNotFoundError(
            f'no checkpoint tracking {metric} in {checkpoints_dir}')
    return max(candidates, key=lambda x: x[1])[0]


def build_model(arch, model_kwargs, flax_params, device):
    """A registered model on ``device`` holding a flax parameter tree."""
    model = ModelRegistry.get(arch)(**model_kwargs, device=device)
    model.load_state_dict(model.from_flax(flax_params))
    return model.eval()


def load_model(model_dir, checkpoint_path, cfg, device):
    """The model of a JAX-package model directory, with the checkpoint's
    EMA parameters where it has them."""
    state = load_checkpoint(checkpoint_path)
    params = state['ema'] if 'ema' in state else state['params']
    return build_model(cfg.arch, cfg.model.to_dict(), params, device)


class EnhanceService:
    """Owns the model and serializes enhance calls."""

    def __init__(self, model_dir, device, best=None):
        from brever_tpu.config import get_config  # needs yaml

        cfg = get_config(os.path.join(model_dir, 'config.yaml'))
        ckpt_dir = os.path.join(model_dir, 'checkpoints')
        if best:
            ckpt = find_best_checkpoint(ckpt_dir, best)
        else:
            ckpt = os.path.join(ckpt_dir, 'last.ckpt')
        self._setup(cfg.arch, load_model(model_dir, ckpt, cfg, device),
                    os.path.basename(ckpt))

    @classmethod
    def from_params(cls, arch, model_kwargs, flax_params, device):
        """A service over an in-memory flax-layout parameter tree."""
        service = cls.__new__(cls)
        service._setup(arch, build_model(arch, model_kwargs, flax_params,
                                         device), None)
        return service

    def _setup(self, arch, model, checkpoint):
        self.model = model
        self.arch = arch
        self.fs = getattr(model, 'fs', 16000)
        self.n_params = count_params(model)
        self.checkpoint = checkpoint
        self._lock = threading.Lock()

    def warmup(self, n_samples=16000):
        self.enhance(np.zeros(n_samples, np.float32))

    def enhance(self, audio):
        """audio: (samples,) or (samples, channels) float -> (samples,)
        enhanced mono."""
        audio = np.atleast_2d(np.asarray(audio, np.float32))
        if audio.shape[0] > audio.shape[1]:
            audio = audio.T                       # -> (channels, samples)
        if audio.shape[0] == 1:
            audio = np.repeat(audio, 2, axis=0)   # models expect binaural
        with self._lock:
            out = self.model.enhance(audio[None]).cpu().numpy()[0]
        if out.ndim > 1:
            out = out[0]
        return out[:audio.shape[1]]

    def health(self):
        return {
            'status': 'ok',
            'arch': self.arch,
            'params': int(self.n_params),
            'fs': int(self.fs),
            'checkpoint': self.checkpoint,
            'device': str(self.model.device),
        }


class _Handler(BaseHTTPRequestHandler):
    service = None  # set by make_http_server

    def log_message(self, fmt, *args):  # quiet by default
        pass

    def _reply(self, code, body, content_type):
        self.send_response(code)
        self.send_header('Content-Type', content_type)
        self.send_header('Content-Length', str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _error(self, code, message):
        self._reply(code, json.dumps({'error': message}).encode(),
                    'application/json')

    def do_GET(self):
        if self.path != '/health':
            self._error(404, 'not found')
            return
        self._reply(200, json.dumps(self.service.health()).encode(),
                    'application/json')

    def do_POST(self):
        if self.path == '/enhance_stream':
            self._error(400, 'streaming needs a causal model, which the '
                        'PyTorch port does not serve yet')
            return
        if self.path != '/enhance':
            self._error(404, 'not found')
            return
        length = int(self.headers.get('Content-Length', 0))
        raw = self.rfile.read(length)
        try:
            audio, fs = read_wav(io.BytesIO(raw), always_2d=True)
        except (ValueError, EOFError) as e:
            self._error(400, f'bad WAV payload: {e}')
            return
        if fs != self.service.fs:
            self._error(400, f'expected {self.service.fs} Hz, got {fs}')
            return
        out = self.service.enhance(audio)
        buf = io.BytesIO()
        write_wav(buf, out[:, None], fs)
        self._reply(200, buf.getvalue(), 'audio/wav')


def make_http_server(service, host='127.0.0.1', port=0):
    """An HTTP server over ``service``; the caller runs
    ``serve_forever()``."""
    handler = type('Handler', (_Handler,), {'service': service})
    return ThreadingHTTPServer((host, port), handler)


def make_server(model_dir, device, host='127.0.0.1', port=0, best=None,
                warmup=True):
    """Build (server, service) for a model directory."""
    service = EnhanceService(model_dir, device, best=best)
    if warmup:
        service.warmup()
    return make_http_server(service, host, port), service


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('model_dir')
    parser.add_argument('--device', default='cuda',
                        help="torch device to serve on (e.g. 'cuda', "
                        "'cuda:1', 'cpu')")
    parser.add_argument('--host', default='127.0.0.1')
    parser.add_argument('--port', type=int, default=8000)
    parser.add_argument('--best', default=None)
    args = parser.parse_args()
    server, service = make_server(args.model_dir, args.device, args.host,
                                  args.port, args.best)
    h = service.health()
    print(f'serving {h["arch"]} ({h["params"]:,} params, '
          f'{h["checkpoint"]}) on {h["device"]} at http://{args.host}:'
          f'{server.server_address[1]}', flush=True)
    server.serve_forever()


if __name__ == '__main__':
    main()
