"""Build the port's CUDA sources with ``nvcc`` and load them with ctypes.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc``, all started
together, and the objects are linked into one shared library with a plain
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
              '-O3', '-Xcompiler', '-fPIC']

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


class TcnBwdArgs(ctypes.Structure):
    """``struct TcnBwdArgs`` of csrc/tcn_block_bwd.cu, field for field."""
    _fields_ = [(name, _P) for name in (
        'x', 'g_res', 'g_skip', 'stats', 'w_in', 'b_in', 'a1', 'g1', 'be1',
        'w_dw', 'b_dw', 'a2', 'g2', 'be2', 'w_res', 'w_skip', 'dx', 'dw_in',
        'db_in', 'da', 'dgb1', 'dwb_dw', 'dgb2', 'dw_out', 'db_out',
        'work')] + [(name, _I) for name in (
            'B', 'T', 'C', 'H', 'Cs', 'last', 'dilation')]


#: C entry points of csrc/*.cu: name -> (restype, argtypes)
SIGNATURES = {
    'tcn_in_partials': (_I, [_I, _I]),
    'tcn_dw_partials': (_I, [_I, _I]),
    'brever_error_string': (ctypes.c_char_p, [_I]),
    'tcn_in_gemm_prelu_stats': (_I, [_P] * 6 + [_I] * 4 + [_P]),
    'tcn_row_stats': (_I, [_P, _I, _P, _I, _I, _F, _P]),
    'tcn_dw_prelu_stats': (_I, [_P] * 9 + [_I] * 4 + [_P]),
    'tcn_out_gemm': (_I, [_P] * 11 + [_I] * 6 + [_P]),
    'tcn_bwd_workspace': (ctypes.c_size_t, [_I] * 6),
    'tcn_block_bwd': (_I, [ctypes.POINTER(TcnBwdArgs), _P]),
    'lstm_fwd_smem': (ctypes.c_size_t, [_I, _I]),
    'lstm_bwd_smem': (ctypes.c_size_t, [_I, _I]),
    'lstm_bwd_workspace': (ctypes.c_size_t, [_I] * 5),
    'lstm_fwd': (_I, [_P] * 6 + [_I] * 5 + [_P]),
    'lstm_bwd': (_I, [_P] * 12 + [_I] * 5 + [_P]),
    'lstm_scan_bwd_workspace': (ctypes.c_size_t, [_I] * 4),
    'lstm_scan_fwd': (_I, [_P] * 4 + [_I] * 4 + [_P]),
    'lstm_scan_bwd': (_I, [_P] * 9 + [_I] * 4 + [_P]),
    'gn_workspace': (ctypes.c_size_t, [_I] * 4),
    'gn_fwd': (_I, [_P] * 7 + [_I] * 4 + [_F, _I, _P]),
    'gn_bwd': (_I, [_P] * 10 + [_I] * 5 + [_P]),
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


def _run(cmds):
    """Run the commands in parallel; raise with the first failure's
    output."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    failed = None
    for cmd, proc in procs:
        out = proc.communicate()[0]
        if proc.returncode != 0 and failed is None:
            failed = (cmd, proc.returncode, out)
    if failed is not None:
        cmd, code, out = failed
        raise RuntimeError(f'nvcc failed ({code}): {" ".join(cmd)}\n{out}')


def build():
    """Compile csrc/*.cu into the hashed library unless it exists (one
    nvcc per source, in parallel, then one link); returns its path.
    Raises RuntimeError with nvcc's output on failure."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f'{path}.{os.getpid()}.tmp'
    nvcc = find_nvcc()
    objects, compiles = [], []
    for src in sources():
        if src.endswith('.cu'):
            obj = f'{tmp}.{os.path.basename(src)}.o'
            objects.append(obj)
            compiles.append([nvcc, *NVCC_FLAGS, '-c', src, '-o', obj])
    try:
        _run(compiles)
        _run([[nvcc, *NVCC_FLAGS, '-shared', '-o', tmp, *objects]])
    finally:
        for obj in objects:
            if os.path.exists(obj):
                os.remove(obj)
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
    """Raise if a C entry point returned a CUDA error code (named by the
    library's one error-string entry point)."""
    if code != 0:
        raise RuntimeError(
            f'{what} failed: CUDA error {code} '
            f'({lib.brever_error_string(code).decode()})')
