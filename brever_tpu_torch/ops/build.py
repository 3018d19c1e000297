"""Build the port's CUDA sources with ``nvcc`` and load them with ctypes.

Every ``csrc/*.cu`` file is compiled into one shared library with a plain
C interface (no PyTorch headers, so a build takes seconds). The library
goes to ``build/brever_tpu_torch/`` at the root of the checkout and is
named by a hash of the sources and flags, so an edited source rebuilds.
Nothing is built or loaded until :func:`load_library` is first called.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PACKAGE_DIR, 'csrc')
BUILD_DIR = os.path.join(os.path.dirname(PACKAGE_DIR), 'build',
                         'brever_tpu_torch')

NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC']

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

#: C entry points of csrc/*.cu: name -> (restype, argtypes)
SIGNATURES = {
    'tcn_in_partials': (_I, [_I, _I]),
    'tcn_dw_partials': (_I, [_I, _I]),
    'tcn_error_string': (ctypes.c_char_p, [_I]),
    'tcn_in_gemm_prelu_stats': (_I, [_P] * 6 + [_I] * 4 + [_P]),
    'tcn_dw_prelu_stats': (_I, [_P] * 9 + [_I] * 4 + [_F, _P]),
    'tcn_out_gemm': (_I, [_P] * 11 + [_I] * 6 + [_F, _P]),
}

_lock = threading.Lock()
_library = None


def find_nvcc():
    for candidate in (os.environ.get('CUDA_HOME'), '/usr/local/cuda'):
        if candidate:
            path = os.path.join(candidate, 'bin', 'nvcc')
            if os.access(path, os.X_OK):
                return path
    path = shutil.which('nvcc')
    if path is None:
        raise RuntimeError(
            'nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin '
            'and PATH): the CUDA kernels cannot be built')
    return path


def sources():
    return sorted(os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR)
                  if f.endswith(('.cu', '.cuh')))


def library_path():
    digest = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for path in sources():
        digest.update(os.path.basename(path).encode())
        with open(path, 'rb') as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR,
                        f'libbrever_kernels_{digest.hexdigest()[:16]}.so')


def build():
    """Compile csrc/*.cu into the hashed library unless it exists;
    returns its path. Raises RuntimeError with nvcc's output on
    failure."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f'{path}.{os.getpid()}.tmp'
    cmd = [find_nvcc(), *NVCC_FLAGS, '-o', tmp,
           *[s for s in sources() if s.endswith('.cu')]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f'nvcc failed ({proc.returncode}): '
                           f'{" ".join(cmd)}\n{proc.stdout}{proc.stderr}')
    os.replace(tmp, path)
    return path


def load_library():
    """The built kernel library with typed entry points (built at first
    use)."""
    global _library
    with _lock:
        if _library is None:
            lib = ctypes.CDLL(build())
            for name, (restype, argtypes) in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype = restype
                fn.argtypes = argtypes
            _library = lib
    return _library


def check(lib, code, what):
    """Raise if a C entry point returned a CUDA error code."""
    if code != 0:
        raise RuntimeError(
            f'{what} failed: CUDA error {code} '
            f'({lib.tcn_error_string(code).decode()})')
