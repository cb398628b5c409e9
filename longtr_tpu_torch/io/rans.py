"""rANS 4x8 codec (CRAM 3.0 block compression method 4).

Implements the byte-oriented static rANS coder from the CRAM 3.0
specification (section 13 "rANS codec"): order-0 and order-1 models,
12-bit (4096) normalized frequencies, four interleaved decoder states,
renormalization bound 2^23.  The reference toolchain gets this from
htslib; we implement it from the published specification.

Encoder and decoder are both provided: the encoder serves test fixtures
and the CRAM writer, the decoder the CRAM reader.  Hot paths are plain
Python over bytearrays — adequate for the slice sizes LongTR touches
(CRAM external blocks are decoded once per container).
"""

from __future__ import annotations

RANS_L = 1 << 23          # lower renormalization bound
TF_SHIFT = 12             # total frequency = 4096
TOTFREQ = 1 << TF_SHIFT


# ---------------------------------------------------------------------------
# frequency tables

def _normalize(freqs, total=TOTFREQ):
    """Scale raw counts so they sum to ``total`` with every nonzero count
    kept nonzero (spec: frequencies must sum to 4096)."""
    t = sum(freqs)
    if t == 0:
        return freqs
    out = [0] * len(freqs)
    # largest remainder with nonzero floor
    acc = 0
    max_i = 0
    for i, f in enumerate(freqs):
        if not f:
            continue
        nf = f * total // t
        if nf == 0:
            nf = 1
        out[i] = nf
        acc += nf
        if out[i] > out[max_i]:
            max_i = i
    out[max_i] += total - acc
    if out[max_i] <= 0:
        # pathological skew; rebalance by stealing from the largest others
        deficit = 1 - out[max_i]
        out[max_i] = 1
        for i in sorted(range(len(out)), key=lambda k: -out[k]):
            if i == max_i:
                continue
            take = min(deficit, out[i] - 1)
            out[i] -= take
            deficit -= take
            if not deficit:
                break
    return out


def _write_freqs_o0(freqs):
    """Order-0 table serialization: ascending symbols with RLE over runs of
    consecutive symbols; frequencies as 1-2 bytes (hi bit = 2-byte form);
    0x00 terminator."""
    out = bytearray()
    syms = [i for i, f in enumerate(freqs) if f]
    rle = 0
    last = -2
    for s in syms:
        if rle:
            rle -= 1
        else:
            out.append(s)
            if s == last + 1:
                # count following consecutive symbols
                run = 0
                j = syms.index(s)
                while j + run + 1 < len(syms) and syms[j + run + 1] == s + run + 1:
                    run += 1
                out.append(run)
                rle = run
        f = freqs[s]
        if f < 0x80:
            out.append(f)
        else:
            out.append(0x80 | (f >> 8))
            out.append(f & 0xFF)
        last = s
    out.append(0)
    return bytes(out)


def _read_freqs_o0(data, pos):
    freqs = [0] * 256
    rle = 0
    sym = data[pos]
    pos += 1
    last = -2
    while True:
        if rle:
            rle -= 1
            cur = last + 1
        else:
            cur = sym
            if cur == last + 1:
                rle = data[pos]
                pos += 1
        f = data[pos]
        pos += 1
        if f & 0x80:
            f = ((f & 0x7F) << 8) | data[pos]
            pos += 1
        freqs[cur] = f
        last = cur
        if rle:
            continue
        sym = data[pos]
        pos += 1
        if sym == 0:
            break
    return freqs, pos


def _cum_table(freqs):
    cum = [0] * 257
    for i in range(256):
        cum[i + 1] = cum[i] + freqs[i]
    # symbol lookup by 12-bit slot
    lut = bytearray(TOTFREQ)
    for s in range(256):
        if freqs[s]:
            start = cum[s]
            for k in range(freqs[s]):
                lut[start + k] = s
    return cum, lut


# ---------------------------------------------------------------------------
# order-0

def _encode_o0(data: bytes) -> bytes:
    counts = [0] * 256
    for b in data:
        counts[b] += 1
    freqs = _normalize(counts)
    cum, _ = _cum_table(freqs)

    states = [RANS_L] * 4
    out = bytearray()
    # encode in reverse, interleaving streams round-robin by position
    for i in range(len(data) - 1, -1, -1):
        j = i & 3
        s = data[i]
        f, c = freqs[s], cum[s]
        x = states[j]
        x_max = ((RANS_L >> TF_SHIFT) << 8) * f
        while x >= x_max:
            out.append(x & 0xFF)
            x >>= 8
        states[j] = ((x // f) << TF_SHIFT) + (x % f) + c
    head = bytearray()
    for j in range(4):
        head += states[j].to_bytes(4, "little")
    body = head + bytes(reversed(out))
    return _write_freqs_o0(freqs) + body


def _decode_o0(data, pos, out_sz) -> bytes:
    freqs, pos = _read_freqs_o0(data, pos)
    cum, lut = _cum_table(freqs)
    states = []
    for j in range(4):
        states.append(int.from_bytes(data[pos:pos + 4], "little"))
        pos += 4
    out = bytearray(out_sz)
    n = len(data)
    for i in range(out_sz):
        j = i & 3
        x = states[j]
        slot = x & (TOTFREQ - 1)
        s = lut[slot]
        out[i] = s
        x = freqs[s] * (x >> TF_SHIFT) + slot - cum[s]
        while x < RANS_L and pos < n:
            x = (x << 8) | data[pos]
            pos += 1
        states[j] = x
    return bytes(out)


# ---------------------------------------------------------------------------
# order-1

def _write_freqs_o1(freqs2):
    out = bytearray()
    ctxs = [c for c in range(256) if any(freqs2[c])]
    rle = 0
    last = -2
    for c in ctxs:
        if rle:
            rle -= 1
        else:
            out.append(c)
            if c == last + 1:
                run = 0
                j = ctxs.index(c)
                while j + run + 1 < len(ctxs) and ctxs[j + run + 1] == c + run + 1:
                    run += 1
                out.append(run)
                rle = run
        out += _write_freqs_o0(freqs2[c])
        last = c
    out.append(0)
    return bytes(out)


def _read_freqs_o1(data, pos):
    freqs2 = [[0] * 256 for _ in range(256)]
    rle = 0
    sym = data[pos]
    pos += 1
    last = -2
    while True:
        if rle:
            rle -= 1
            cur = last + 1
        else:
            cur = sym
            if cur == last + 1:
                rle = data[pos]
                pos += 1
        freqs2[cur], pos = _read_freqs_o0(data, pos)
        last = cur
        if rle:
            continue
        sym = data[pos]
        pos += 1
        if sym == 0:
            break
    return freqs2, pos


def _encode_o1(data: bytes) -> bytes:
    n = len(data)
    isz4 = n >> 2
    counts = [[0] * 256 for _ in range(256)]
    # four streams, each with context chains starting at context 0
    starts = [0, isz4, 2 * isz4, 3 * isz4]
    ends = [isz4, 2 * isz4, 3 * isz4, n]
    for j in range(4):
        last = 0
        for i in range(starts[j], ends[j]):
            counts[last][data[i]] += 1
            last = data[i]
    freqs2 = [(_normalize(c) if any(c) else c) for c in counts]
    cums = {}
    for c in range(256):
        if any(freqs2[c]):
            cums[c] = _cum_table(freqs2[c])[0]

    states = [RANS_L] * 4
    outs = bytearray()
    # encode each stream in reverse; interleave renorm bytes by always
    # processing the streams in round-robin over a shared position grid
    # (spec: streams are independent; bytes interleave naturally because
    # encode order is the exact reverse of decode order)
    idx = [ends[j] - 1 for j in range(4)]
    # We must emit bytes in reverse of the decoder's consumption order.
    # Decoder consumes: for i in 0..isz4-1: for j in 0..3 -> renorms.
    # Tail (stream 3 beyond isz4) is decoded last, so encode it first.
    def enc_one(j, i, x):
        prev = data[i - 1] if i > starts[j] else 0
        s = data[i]
        f = freqs2[prev][s]
        c = cums[prev][s]
        x_max = ((RANS_L >> TF_SHIFT) << 8) * f
        while x >= x_max:
            outs.append(x & 0xFF)
            x >>= 8
        return ((x // f) << TF_SHIFT) + (x % f) + c

    while idx[3] >= starts[3] + isz4:
        states[3] = enc_one(3, idx[3], states[3])
        idx[3] -= 1
    for step in range(isz4 - 1, -1, -1):
        for j in (3, 2, 1, 0):
            states[j] = enc_one(j, starts[j] + step, states[j])
    head = bytearray()
    for j in range(4):
        head += states[j].to_bytes(4, "little")
    return _write_freqs_o1(freqs2) + bytes(head) + bytes(reversed(outs))


def _decode_o1(data, pos, out_sz) -> bytes:
    freqs2, pos = _read_freqs_o1(data, pos)
    tabs = {}
    for c in range(256):
        if any(freqs2[c]):
            tabs[c] = _cum_table(freqs2[c])
    states = []
    for j in range(4):
        states.append(int.from_bytes(data[pos:pos + 4], "little"))
        pos += 4
    out = bytearray(out_sz)
    isz4 = out_sz >> 2
    starts = [0, isz4, 2 * isz4, 3 * isz4]
    last = [0, 0, 0, 0]
    n = len(data)

    def dec_one(j, x):
        freqs = freqs2[last[j]]
        cum, lut = tabs[last[j]]
        slot = x & (TOTFREQ - 1)
        s = lut[slot]
        x = freqs[s] * (x >> TF_SHIFT) + slot - cum[s]
        return s, x

    for step in range(isz4):
        for j in range(4):
            s, x = dec_one(j, states[j])
            out[starts[j] + step] = s
            last[j] = s
            while x < RANS_L and pos < n:
                x = (x << 8) | data[pos]
                pos += 1
            states[j] = x
    i = starts[3] + isz4
    while i < out_sz:
        s, x = dec_one(3, states[3])
        out[i] = s
        last[3] = s
        while x < RANS_L and pos < n:
            x = (x << 8) | data[pos]
            pos += 1
        states[3] = x
        i += 1
    return bytes(out)


# ---------------------------------------------------------------------------
# public API (CRAM block framing: 1-byte order, u32 comp size, u32 raw size)

def rans_compress(data: bytes, order: int = 0) -> bytes:
    if len(data) < 4:
        order = 0
    payload = _encode_o1(bytes(data)) if order else _encode_o0(bytes(data))
    return (bytes([order]) + len(payload).to_bytes(4, "little")
            + len(data).to_bytes(4, "little") + payload)


def rans_decompress(data: bytes) -> bytes:
    order = data[0]
    out_sz = int.from_bytes(data[5:9], "little")
    if out_sz == 0:
        return b""
    try:
        from longtr_tpu_torch import native
        out = native.rans_decode(bytes(data), out_sz)
        if out is not None:
            return out
    except Exception:
        pass
    if order == 0:
        return _decode_o0(data, 9, out_sz)
    if order == 1:
        return _decode_o1(data, 9, out_sz)
    raise ValueError(f"unsupported rANS order {order}")
