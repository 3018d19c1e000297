"""Dependency-free FLAC codec over numpy (the port's own copy of
``brever_tpu/flac.py``, kept byte for byte in what it computes).

Datasets that ``scripts/create_dataset.py`` writes are FLAC by default,
and ``soundfile`` is not a dependency of the port, so the port reads and
writes the format itself:

* **decoder** -- the full fixed-blocksize subset produced by every
  mainstream encoder: constant / verbatim / fixed(0-4) / LPC(1-32)
  subframes, Rice / Rice2 residual partitions with escape codes,
  wasted bits, and the independent / left-side / right-side / mid-side
  channel assignments, with the UTF-8-coded frame numbers.
* **encoder** -- 16-bit fixed-blocksize streams with per-frame best-of
  fixed(0-2)/LPC(8) prediction and single-partition Rice residuals,
  CRC-8 frame headers and CRC-16 frames: the same bytes as the JAX
  package's encoder (``tests/test_torch_flac.py``).

numpy only: no torch import.
"""

import bisect
import hashlib
import struct

import numpy as np

_FIXED_COEFS = {
    0: [],
    1: [1],
    2: [2, -1],
    3: [3, -3, 1],
    4: [4, -6, 4, -1],
}

_BLOCKSIZE = 4096


class FlacError(ValueError):
    pass


# ----------------------------------------------------------------------
# bit reader


class _BitReader:
    def __init__(self, buf):
        self.buf = buf
        self.pos = 0          # bit position
        self.bits = np.unpackbits(np.frombuffer(buf, np.uint8))
        self._ones = None     # lazy: sorted bit positions of 1-bits
        self._raw = None      # lazy: zero-padded raw bytes

    def _ones_positions(self):
        """Sorted positions of every 1-bit, as a Python list (built
        once per stream; rice decoding walks it instead of running one
        ``argmax`` per residual)."""
        if self._ones is None:
            self._ones = np.flatnonzero(self.bits).tolist()
            # 5-byte zero pad: remainder-field windows near EOF stay
            # in-bounds (overruns are caught by the final pos check)
            self._raw = bytes(self.buf) + b'\x00' * 5
        return self._ones

    def read_uint(self, n):
        if n == 0:
            return 0
        end = self.pos + n
        chunk = self.bits[self.pos:end]
        if len(chunk) < n:
            raise FlacError('unexpected end of stream')
        self.pos = end
        out = 0
        for b in chunk.tolist():
            out = (out << 1) | b
        return out

    def read_int(self, n):
        v = self.read_uint(n)
        if v >= 1 << (n - 1):
            v -= 1 << n
        return v

    def read_unary(self):
        if self.pos >= len(self.bits):
            raise FlacError('unexpected end of stream in unary code')
        idx = int(np.argmax(self.bits[self.pos:]))
        if not self.bits[self.pos + idx]:
            raise FlacError('unexpected end of stream in unary code')
        self.pos += idx + 1
        return idx

    def align(self):
        self.pos = (self.pos + 7) & ~7

    def byte_pos(self):
        return self.pos >> 3

    def read_rice_block(self, n, param):
        """Decode ``n`` rice(param) residuals.

        The scalar form ran one ``np.argmax`` (unary terminator) plus a
        per-bit Python loop (remainder) per residual — ~4 us/sample and
        the dominant cost of the Python decode path. This walks the
        precomputed 1-bit index instead (each terminator is the next
        indexed 1 after skipping the ones inside the previous remainder
        field — its popcount) and reads each remainder from a 5-byte
        window of the raw buffer: ~0.3 us/sample, identical output."""
        out = np.empty(n, np.int64)
        if n == 0:
            return out
        ones = self._ones_positions()
        raw = self._raw
        pos = self.pos
        k = bisect.bisect_left(ones, pos)
        mask = (1 << param) - 1
        rem_shift = 40 - param
        try:
            for i in range(n):
                term = ones[k]
                q = term - pos
                pos = term + 1
                if param:
                    window = int.from_bytes(
                        raw[pos >> 3:(pos >> 3) + 5], 'big')
                    r = (window >> (rem_shift - (pos & 7))) & mask
                    k += 1 + r.bit_count()
                    pos += param
                    u = (q << param) | r
                else:
                    k += 1
                    u = q
                out[i] = (u >> 1) ^ -(u & 1)
        except IndexError:
            raise FlacError('unexpected end of stream') from None
        if pos > len(self.bits):
            raise FlacError('unexpected end of stream')
        self.pos = pos
        return out


# ----------------------------------------------------------------------
# decoder


def _read_utf8_coded(r):
    """FLAC's extended UTF-8 frame/sample number."""
    first = r.read_uint(8)
    if first < 0x80:
        return first
    n_extra = 0
    mask = 0x40
    while first & mask:
        n_extra += 1
        mask >>= 1
    if n_extra == 0 or n_extra > 6:
        raise FlacError('invalid UTF-8 coded number')
    value = first & (mask - 1)
    for _ in range(n_extra):
        b = r.read_uint(8)
        if b & 0xC0 != 0x80:
            raise FlacError('invalid UTF-8 continuation byte')
        value = (value << 6) | (b & 0x3F)
    return value


def _decode_residual(r, blocksize, order):
    method = r.read_uint(2)
    if method > 1:
        raise FlacError(f'reserved residual method {method}')
    param_bits = 4 + method
    escape = (1 << param_bits) - 1
    porder = r.read_uint(4)
    n_partitions = 1 << porder
    if blocksize % n_partitions:
        raise FlacError('blocksize not divisible by partition count')
    part_len = blocksize >> porder
    out = np.empty(blocksize - order, np.int64)
    filled = 0
    for p in range(n_partitions):
        n = part_len - (order if p == 0 else 0)
        param = r.read_uint(param_bits)
        if param == escape:
            raw_bits = r.read_uint(5)
            vals = np.array([r.read_int(raw_bits) if raw_bits else 0
                             for _ in range(n)], np.int64)
        else:
            vals = r.read_rice_block(n, param)
        out[filled:filled + n] = vals
        filled += n
    return out


def _integrate_fixed(warmup, res, order):
    """Invert a FIXED(order) predictor.

    Fixed predictors are exact finite differences — the residual is
    ``Delta^order(signal)`` — so reconstruction is ``order`` nested
    cumulative sums, each seeded with ``Delta^j(warmup)[0]``: fully
    vectorized instead of a per-sample recurrence. Each cumsum grows
    the sequence by one, so the result is the complete blocksize-long
    signal, warmup included."""
    vals = np.asarray(res, np.int64)
    w = np.asarray(warmup, np.int64)
    for j in range(order - 1, -1, -1):
        seed = np.diff(w, n=j)[0:1]
        vals = np.cumsum(np.concatenate([seed, vals]))
    return vals


def _decode_subframe(r, blocksize, bps):
    if r.read_uint(1):
        raise FlacError('invalid subframe header padding bit')
    stype = r.read_uint(6)
    wasted = 0
    if r.read_uint(1):
        wasted = 1 + r.read_unary()
        bps -= wasted
    if stype == 0:      # CONSTANT
        out = np.full(blocksize, r.read_int(bps), np.int64)
    elif stype == 1:    # VERBATIM
        out = np.array([r.read_int(bps) for _ in range(blocksize)],
                       np.int64)
    elif 8 <= stype <= 12:  # FIXED
        order = stype - 8
        warmup = [r.read_int(bps) for _ in range(order)]
        res = _decode_residual(r, blocksize, order)
        out = _integrate_fixed(warmup, res, order)
    elif stype >= 32:   # LPC
        order = (stype & 31) + 1
        warmup = [r.read_int(bps) for _ in range(order)]
        precision = r.read_uint(4) + 1
        if precision == 16:
            raise FlacError('invalid LPC precision')
        shift = r.read_int(5)
        coefs = [r.read_int(precision) for _ in range(order)]
        res = _decode_residual(r, blocksize, order)
        # the IIR recurrence cannot vectorize; plain-int list ops are
        # ~5x cheaper per step than numpy scalar indexing
        out_l = list(warmup)
        rev = list(enumerate(coefs, start=1))  # (lag, coef)
        for e in res.tolist():
            pred = 0
            for lag, c in rev:
                pred += c * out_l[-lag]
            out_l.append(int(e) + (pred >> shift))
        out = np.array(out_l, np.int64)
    else:
        raise FlacError(f'reserved subframe type {stype}')
    return out << wasted


_BLOCKSIZE_TABLE = {1: 192}
for _i in range(2, 6):
    _BLOCKSIZE_TABLE[_i] = 576 << (_i - 2)
for _i in range(8, 16):
    _BLOCKSIZE_TABLE[_i] = 256 << (_i - 8)

_SAMPLE_SIZE_TABLE = {1: 8, 2: 12, 4: 16, 5: 20, 6: 24, 7: 32}


def _parse_streaminfo(data):
    (min_bs, max_bs) = struct.unpack('>HH', data[:4])
    rest = int.from_bytes(data[10:18], 'big')
    sample_rate = rest >> 44
    channels = ((rest >> 41) & 0x7) + 1
    bps = ((rest >> 36) & 0x1F) + 1
    total = rest & ((1 << 36) - 1)
    return dict(min_blocksize=min_bs, max_blocksize=max_bs,
                sample_rate=sample_rate, channels=channels, bps=bps,
                total_samples=total)


def parse_header(buf):
    """Returns (streaminfo dict, offset of first frame)."""
    if buf[:4] != b'fLaC':
        raise FlacError('not a FLAC stream')
    pos = 4
    info = None
    while True:
        if pos + 4 > len(buf):
            raise FlacError('truncated metadata block header')
        header = buf[pos]
        btype = header & 0x7F
        length = int.from_bytes(buf[pos + 1:pos + 4], 'big')
        if pos + 4 + length > len(buf):
            raise FlacError('truncated metadata block body')
        body = buf[pos + 4:pos + 4 + length]
        if btype == 0:
            if length < 34:
                raise FlacError('short STREAMINFO block')
            info = _parse_streaminfo(body)
        pos += 4 + length
        if header & 0x80:
            break
    if info is None:
        raise FlacError('missing STREAMINFO block')
    return info, pos


def decode(buf, max_frames=None):
    """Decode a FLAC stream to (samples (frames, channels) int32, info).

    ``max_frames`` stops early once that many frames are decoded.
    """
    buf = bytes(buf)
    info, pos = parse_header(buf)
    channels = info['channels']
    total = info['total_samples'] or None
    want = total if max_frames is None else (
        min(total, max_frames) if total else max_frames)
    chunks = []
    decoded = 0
    r = _BitReader(buf[pos:])
    n_bits = len(r.bits)
    while (want is None or decoded < want) and r.pos + 15 < n_bits:
        sync = r.read_uint(14)
        if sync != 0x3FFE:
            raise FlacError(f'bad frame sync 0x{sync:x}')
        r.read_uint(1)  # reserved
        r.read_uint(1)  # blocking strategy
        bs_code = r.read_uint(4)
        r.read_uint(4)  # sample rate code (streaminfo wins)
        ch_code = r.read_uint(4)
        ss_code = r.read_uint(3)
        r.read_uint(1)  # reserved
        _read_utf8_coded(r)
        if bs_code == 6:
            blocksize = r.read_uint(8) + 1
        elif bs_code == 7:
            blocksize = r.read_uint(16) + 1
        elif bs_code in _BLOCKSIZE_TABLE:
            blocksize = _BLOCKSIZE_TABLE[bs_code]
        else:
            raise FlacError(f'reserved blocksize code {bs_code}')
        sr_code = None  # parsed above; codes 12-14 carry payload bits
        del sr_code
        bps = info['bps'] if ss_code == 0 else _SAMPLE_SIZE_TABLE[ss_code]
        r.read_uint(8)  # CRC-8 (not verified)

        if ch_code < 8:
            n_ch = ch_code + 1
            subs = [_decode_subframe(r, blocksize, bps)
                    for _ in range(n_ch)]
            frame = np.stack(subs, axis=1)
        elif ch_code == 8:    # left/side
            left = _decode_subframe(r, blocksize, bps)
            side = _decode_subframe(r, blocksize, bps + 1)
            frame = np.stack([left, left - side], axis=1)
        elif ch_code == 9:    # right/side
            side = _decode_subframe(r, blocksize, bps + 1)
            right = _decode_subframe(r, blocksize, bps)
            frame = np.stack([right + side, right], axis=1)
        elif ch_code == 10:   # mid/side
            mid = _decode_subframe(r, blocksize, bps)
            side = _decode_subframe(r, blocksize, bps + 1)
            m2 = (mid << 1) | (side & 1)
            frame = np.stack([(m2 + side) >> 1, (m2 - side) >> 1],
                             axis=1)
        else:
            raise FlacError(f'reserved channel assignment {ch_code}')
        if frame.shape[1] != channels:
            raise FlacError('channel count changed mid-stream')
        r.align()
        r.read_uint(16)  # CRC-16 (not verified)
        chunks.append(frame)
        decoded += blocksize

    out = np.concatenate(chunks, axis=0) if chunks else \
        np.zeros((0, channels), np.int64)
    if want is not None:
        out = out[:want]
    return out.astype(np.int32), info


# ----------------------------------------------------------------------
# encoder


class _BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.nbits = 0

    def write_uint(self, value, n):
        if n == 0:
            return
        self.acc = (self.acc << n) | (value & ((1 << n) - 1))
        self.nbits += n
        while self.nbits >= 8:
            self.nbits -= 8
            self.out.append((self.acc >> self.nbits) & 0xFF)
        self.acc &= (1 << self.nbits) - 1

    def write_int(self, value, n):
        self.write_uint(value & ((1 << n) - 1), n)

    def align(self):
        if self.nbits:
            self.write_uint(0, 8 - self.nbits)

    def getvalue(self):
        assert self.nbits == 0
        return bytes(self.out)


def _make_crc_table(poly, width):
    mask = (1 << width) - 1
    top = 1 << (width - 1)
    table = []
    for b in range(256):
        crc = b << (width - 8)
        for _ in range(8):
            crc = ((crc << 1) ^ poly) & mask if crc & top \
                else (crc << 1) & mask
        table.append(crc)
    return table


_CRC8_TABLE = _make_crc_table(0x07, 8)
_CRC16_TABLE = _make_crc_table(0x8005, 16)


def _crc8(data):
    crc = 0
    table = _CRC8_TABLE
    for b in data:
        crc = table[crc ^ b]
    return crc


def _crc16(data):
    crc = 0
    table = _CRC16_TABLE
    for b in data:
        crc = ((crc << 8) & 0xFF00) ^ table[(crc >> 8) ^ b]
    return crc


def _utf8_coded(value):
    if value < 0x80:
        return bytes([value])
    out = []
    n = 1
    while value >= (1 << (6 * n + (6 - n))) and n < 6:
        n += 1
    lead_bits = 6 - n
    out.append((0xFF << (lead_bits + 1)) & 0xFF
               | (value >> (6 * n)) & ((1 << lead_bits) - 1))
    for i in range(n - 1, -1, -1):
        out.append(0x80 | ((value >> (6 * i)) & 0x3F))
    return bytes(out)


def _best_rice_param(res):
    """Exact-size best single-partition rice parameter."""
    # zigzag: u = (v << 1) ^ (v >> 63)
    u = (res.astype(np.int64) << 1) ^ (res.astype(np.int64) >> 63)
    best_param, best_size = 0, None
    mean = float(u.mean()) if len(u) else 0.0
    center = max(0, int(np.log2(mean + 1)))
    for param in range(max(0, center - 2), min(30, center + 3)):
        size = int((u >> param).sum()) + len(u) * (param + 1)
        if best_size is None or size < best_size:
            best_param, best_size = param, size
    return best_param, best_size or 0


def _rice_encode(w, res, param):
    u = (res.astype(np.int64) << 1) ^ (res.astype(np.int64) >> 63)
    # one write per code: q zeros, the terminating 1 and the
    # param-bit remainder are a single (q+1+param)-bit integer
    if param:
        mask = (1 << param) - 1
        top = 1 << param
        for v in u.tolist():
            w.write_uint(top | (v & mask), (v >> param) + 1 + param)
    else:
        for v in u.tolist():
            w.write_uint(1, v + 1)


def _lpc_analyze(x, order=8, precision=12):
    """Levinson-Durbin on the windowed signal -> quantized coefficients.

    Returns (coefs int list, shift) or None if unstable/degenerate.
    """
    n = len(x)
    if n <= order * 2:
        return None
    w = np.hanning(n)
    xw = x.astype(np.float64) * w
    auto = np.array([np.dot(xw[:n - k], xw[k:]) for k in range(order + 1)])
    if auto[0] == 0:
        return None
    err = auto[0]
    a = np.zeros(order)
    for i in range(order):
        acc = auto[i + 1] - np.dot(a[:i], auto[i:0:-1][:i])
        k = acc / err
        a[:i + 1] = np.concatenate([a[:i] - k * a[:i][::-1], [k]])
        err *= 1 - k * k
        if err <= 0:
            return None
    cmax = np.abs(a).max()
    if cmax == 0 or not np.isfinite(cmax):
        return None
    shift = min(14, max(1, precision - 1 - int(np.ceil(np.log2(cmax)))))
    q = np.round(a * (1 << shift)).astype(np.int64)
    limit = 1 << (precision - 1)
    q = np.clip(q, -limit, limit - 1)
    if not q.any():
        return None
    return q.tolist(), shift


def _lpc_residual(x, coefs, shift):
    order = len(coefs)
    x64 = x.astype(np.int64)
    pred = np.zeros(len(x) - order, np.int64)
    for j, c in enumerate(coefs):
        pred += c * x64[order - 1 - j:len(x) - 1 - j]
    return x64[order:] - (pred >> shift)


def _fixed_residual(x, order):
    res = x.astype(np.int64)
    for _ in range(order):
        res = np.diff(res)
    return res


def _encode_subframe(w, x, bps):
    """Best-of constant/fixed(0-2)/LPC(8) subframe for one channel."""
    if np.all(x == x[0]):
        w.write_uint(0, 1 + 6 + 1)  # constant, no wasted bits
        w.write_int(int(x[0]), bps)
        return
    candidates = []
    for order in (0, 1, 2):
        res = _fixed_residual(x, order)
        param, size = _best_rice_param(res)
        candidates.append((size + order * bps, 'fixed', order, None,
                           None, res, param))
    lpc = _lpc_analyze(x)
    if lpc is not None:
        coefs, shift = lpc
        res = _lpc_residual(x, coefs, shift)
        param, size = _best_rice_param(res)
        candidates.append((size + len(coefs) * (bps + 12) + 9, 'lpc',
                           len(coefs), coefs, shift, res, param))
    _, kind, order, coefs, shift, res, param = min(candidates)

    w.write_uint(0, 1)  # padding
    if kind == 'fixed':
        w.write_uint(8 + order, 6)
    else:
        w.write_uint(32 | (order - 1), 6)
    w.write_uint(0, 1)  # no wasted bits
    for v in x[:order].tolist():
        w.write_int(int(v), bps)
    if kind == 'lpc':
        w.write_uint(12 - 1, 4)       # precision 12
        w.write_int(shift, 5)
        for c in coefs:
            w.write_int(int(c), 12)
    # residual: method 0 (rice 4-bit), partition order 0
    w.write_uint(0, 2)
    w.write_uint(0, 4)
    if param >= 15:
        w.write_uint(15, 4)           # escape to raw
        raw_bits = max(int(np.abs(res).max()).bit_length() + 1, 1)
        w.write_uint(raw_bits, 5)
        for v in res.tolist():
            w.write_int(int(v), raw_bits)
    else:
        w.write_uint(param, 4)
        _rice_encode(w, res, param)


def encode(samples, sample_rate, bps=16):
    """Encode (frames, channels) int16/int32 samples to a FLAC stream."""
    samples = np.asarray(samples)
    if samples.ndim == 1:
        samples = samples[:, None]
    if bps != 16:
        raise FlacError('the encoder writes 16-bit streams')
    samples = samples.astype(np.int32)
    frames, channels = samples.shape
    if not 1 <= channels <= 8:
        raise FlacError(f'unsupported channel count {channels}')

    md5 = hashlib.md5(
        samples.astype('<i2').tobytes())

    body = bytearray()
    frame_sizes = []
    for fi, start in enumerate(range(0, frames, _BLOCKSIZE)):
        block = samples[start:start + _BLOCKSIZE]
        blocksize = len(block)
        w = _BitWriter()
        w.write_uint(0x3FFE, 14)
        w.write_uint(0, 1)       # reserved
        w.write_uint(0, 1)       # fixed blocksize stream
        if blocksize == _BLOCKSIZE:
            bs_code, bs_payload = 12, None   # 4096 = 256 << 4
        else:
            bs_code, bs_payload = 7, blocksize - 1
        w.write_uint(bs_code, 4)
        w.write_uint(0, 4)       # sample rate: from STREAMINFO
        w.write_uint(channels - 1, 4)
        w.write_uint(4, 3)       # 16 bits per sample
        w.write_uint(0, 1)       # reserved
        for b in _utf8_coded(fi):
            w.write_uint(b, 8)
        if bs_payload is not None:
            w.write_uint(bs_payload, 16)
        # CRC-8 over the header so far (bit stream is byte-aligned here)
        partial = bytes(w.out)
        w.write_uint(_crc8(partial), 8)
        for ch in range(channels):
            _encode_subframe(w, block[:, ch], 16)
        w.align()
        frame = bytearray(w.getvalue())
        frame += struct.pack('>H', _crc16(frame))
        frame_sizes.append(len(frame))
        body += frame

    streaminfo = bytearray()
    streaminfo += struct.pack('>HH', _BLOCKSIZE, _BLOCKSIZE)
    streaminfo += min(frame_sizes, default=0).to_bytes(3, 'big')
    streaminfo += max(frame_sizes, default=0).to_bytes(3, 'big')
    packed = (sample_rate << 44) | ((channels - 1) << 41) \
        | ((bps - 1) << 36) | frames
    streaminfo += packed.to_bytes(8, 'big')
    streaminfo += md5.digest()

    out = bytearray(b'fLaC')
    out += bytes([0x80]) + len(streaminfo).to_bytes(3, 'big')
    out += streaminfo
    out += body
    return bytes(out)
