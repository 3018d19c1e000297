"""Read and write the JAX package's msgpack checkpoints without flax or
msgpack.

``brever_tpu.checkpoint.save_checkpoint`` writes
``flax.serialization.msgpack_serialize`` output: nested msgpack maps and
arrays whose array leaves are msgpack extension types. Code 1 is an
ndarray, code 3 a numpy scalar (both carry ``packb((shape, dtype_name,
raw_C_bytes))``), code 2 a complex number (``packb((real, imag))``).
Arrays above 1 GiB are split into ``__msgpack_chunked_array__`` maps.
This module decodes that subset of msgpack in pure Python
(:func:`load_checkpoint`) and encodes it (:func:`save_checkpoint`), so
that a checkpoint the port writes is read by
``brever_tpu.checkpoint.load_checkpoint`` as one of its own.

numpy has no bfloat16, so bfloat16 leaves are widened to float32, which
is exact.
"""

import os
import struct

import numpy as np

_EXT_NDARRAY = 1
_EXT_COMPLEX = 2
_EXT_NPSCALAR = 3


class _Reader:

    def __init__(self, data):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n):
        if self.pos + n > len(self.data):
            raise ValueError('truncated msgpack data')
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt):
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self.take(size))[0]

    def value(self, raw=False):
        b = self.unpack('B')
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.map(b & 0x0f, raw)
        if 0x90 <= b <= 0x9f:
            return self.array(b & 0x0f, raw)
        if 0xa0 <= b <= 0xbf:
            return self.str(b & 0x1f, raw)
        simple = {0xc0: None, 0xc2: False, 0xc3: True}
        if b in simple:
            return simple[b]
        sized = {
            0xc4: ('>B', 'bin'), 0xc5: ('>H', 'bin'), 0xc6: ('>I', 'bin'),
            0xc7: ('>B', 'ext'), 0xc8: ('>H', 'ext'), 0xc9: ('>I', 'ext'),
            0xd9: ('>B', 'str'), 0xda: ('>H', 'str'), 0xdb: ('>I', 'str'),
            0xdc: ('>H', 'array'), 0xdd: ('>I', 'array'),
            0xde: ('>H', 'map'), 0xdf: ('>I', 'map'),
        }
        if b in sized:
            fmt, kind = sized[b]
            n = self.unpack(fmt)
            if kind == 'bin':
                return bytes(self.take(n))
            if kind == 'ext':
                return self.ext(n)
            return getattr(self, kind)(n, raw)
        numbers = {0xca: '>f', 0xcb: '>d', 0xcc: '>B', 0xcd: '>H',
                   0xce: '>I', 0xcf: '>Q', 0xd0: '>b', 0xd1: '>h',
                   0xd2: '>i', 0xd3: '>q'}
        if b in numbers:
            return self.unpack(numbers[b])
        fixext = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}
        if b in fixext:
            return self.ext(fixext[b])
        raise ValueError(f'unsupported msgpack type byte 0x{b:02x}')

    def str(self, n, raw):
        data = bytes(self.take(n))
        return data if raw else data.decode('utf-8')

    def array(self, n, raw):
        return [self.value(raw) for _ in range(n)]

    def map(self, n, raw):
        out = {}
        for _ in range(n):
            key = self.value(raw)
            out[key] = self.value(raw)
        return out

    def ext(self, n):
        code = self.unpack('b')
        payload = bytes(self.take(n))
        if code == _EXT_NDARRAY:
            return _ndarray(payload)
        if code == _EXT_NPSCALAR:
            return _ndarray(payload)[()]
        if code == _EXT_COMPLEX:
            real, imag = unpackb(payload)
            return complex(real, imag)
        raise ValueError(f'unsupported msgpack extension type {code}')


def _ndarray(payload):
    shape, dtype_name, buffer = _Reader(payload).value(raw=True)
    if dtype_name == b'bfloat16':
        bits = np.frombuffer(buffer, dtype='<u2').astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name.decode())) \
        .reshape(shape)


def unpackb(data):
    """Decode one msgpack object (strings as str, arrays as lists)."""
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError('trailing bytes after the msgpack object')
    return out


def _unchunk(tree):
    if not isinstance(tree, dict):
        return tree
    if '__msgpack_chunked_array__' in tree:
        shape = [tree['shape'][str(i)] for i in range(len(tree['shape']))]
        chunks = [tree['chunks'][str(i)] for i in range(len(tree['chunks']))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def load_checkpoint(path):
    """The nested dict that ``brever_tpu.checkpoint.load_checkpoint``
    returns, with numpy leaves (bfloat16 widened to float32)."""
    with open(path, 'rb') as f:
        return _unchunk(unpackb(f.read()))


# ---------------------------------------------------------------------------
# writing

_MAX_LEAF_BYTES = 2 ** 30   # flax chunks leaves above this; the port's
                            # checkpoints stay far below it


def _pack_len(out, n, fix_base, fix_max, codes):
    """Append a length header: fix form below ``fix_max``, else the
    smallest of ``codes`` = ((byte, struct format, limit), ...)."""
    if fix_base is not None and n < fix_max:
        out.append(struct.pack('B', fix_base | n))
        return
    for byte, fmt, limit in codes:
        if n < limit:
            out.append(struct.pack('>B' + fmt, byte, n))
            return
    raise ValueError(f'msgpack object too long: {n}')


def _pack_ext(out, code, payload):
    n = len(payload)
    fixext = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    if n in fixext:
        out.append(struct.pack('>Bb', fixext[n], code))
    else:
        _pack_len(out, n, None, 0, ((0xc7, 'B', 2 ** 8), (0xc8, 'H', 2 ** 16),
                                    (0xc9, 'I', 2 ** 32)))
        out.append(struct.pack('>b', code))
    out.append(payload)


def _ndarray_payload(arr):
    if arr.dtype.hasobject or arr.nbytes > _MAX_LEAF_BYTES:
        raise ValueError(f'cannot write an array of {arr.dtype} and '
                         f'{arr.nbytes} bytes')
    return packb((list(arr.shape), arr.dtype.name, arr.tobytes('C')))


def _pack(out, obj):
    if obj is None:
        out.append(b'\xc0')
    elif obj is True or obj is False:
        out.append(b'\xc3' if obj else b'\xc2')
    elif isinstance(obj, np.ndarray):
        _pack_ext(out, _EXT_NDARRAY, _ndarray_payload(obj))
    elif isinstance(obj, np.generic):
        _pack_ext(out, _EXT_NPSCALAR, _ndarray_payload(np.asarray(obj)))
    elif isinstance(obj, int):
        if 0 <= obj < 2 ** 64:
            if obj < 128:
                out.append(struct.pack('B', obj))
            else:
                for byte, fmt, limit in ((0xcc, 'B', 2 ** 8),
                                         (0xcd, 'H', 2 ** 16),
                                         (0xce, 'I', 2 ** 32),
                                         (0xcf, 'Q', 2 ** 64)):
                    if obj < limit:
                        out.append(struct.pack('>B' + fmt, byte, obj))
                        break
        elif -32 <= obj < 0:
            out.append(struct.pack('b', obj))
        else:
            for byte, fmt, limit in ((0xd0, 'b', 2 ** 7), (0xd1, 'h', 2 ** 15),
                                     (0xd2, 'i', 2 ** 31),
                                     (0xd3, 'q', 2 ** 63)):
                if obj >= -limit:
                    out.append(struct.pack('>B' + fmt, byte, obj))
                    break
            else:
                raise ValueError(f'integer out of msgpack range: {obj}')
    elif isinstance(obj, float):
        out.append(struct.pack('>Bd', 0xcb, obj))
    elif isinstance(obj, str):
        data = obj.encode('utf-8')
        _pack_len(out, len(data), 0xa0, 32, ((0xd9, 'B', 2 ** 8),
                                             (0xda, 'H', 2 ** 16),
                                             (0xdb, 'I', 2 ** 32)))
        out.append(data)
    elif isinstance(obj, bytes):
        _pack_len(out, len(obj), None, 0, ((0xc4, 'B', 2 ** 8),
                                           (0xc5, 'H', 2 ** 16),
                                           (0xc6, 'I', 2 ** 32)))
        out.append(obj)
    elif isinstance(obj, (list, tuple)):
        _pack_len(out, len(obj), 0x90, 16, ((0xdc, 'H', 2 ** 16),
                                            (0xdd, 'I', 2 ** 32)))
        for item in obj:
            _pack(out, item)
    elif isinstance(obj, dict):
        _pack_len(out, len(obj), 0x80, 16, ((0xde, 'H', 2 ** 16),
                                            (0xdf, 'I', 2 ** 32)))
        if not all(isinstance(key, str) for key in obj):
            raise TypeError(f'checkpoint keys must be str, got {list(obj)}')
        for key in sorted(obj):   # flax writes maps in sorted key order
            _pack(out, key)
            _pack(out, obj[key])
    else:
        raise TypeError(f'cannot write {type(obj).__name__} to a checkpoint')


def packb(obj):
    """Encode nested dicts (str keys), lists, str, bytes, bool, None,
    int, float and numpy arrays/scalars byte for byte as
    ``flax.serialization.msgpack_serialize`` does."""
    out = []
    _pack(out, obj)
    return b''.join(out)


def save_checkpoint(path, state):
    """Write ``state`` (numpy leaves) in the layout of
    ``brever_tpu.checkpoint.save_checkpoint``, atomically."""
    data = packb(state)
    tmp = f'{path}.tmp'
    with open(tmp, 'wb') as f:
        f.write(data)
    os.replace(tmp, path)
