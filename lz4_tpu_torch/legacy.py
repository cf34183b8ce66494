"""Joining LZ4 blocks: one block from consecutive payloads.

Legacy files (magic 0x184C2102) hold blocks of 8 MB, and the port's encoder
kernels write blocks of at most 64 KB (kernels A and I) or 256 KB (kernel
B).  Consecutive payloads become one block when each payload's terminal
literal-only sequence is folded into the first sequence of the next: the
new token takes the sum of both literal runs, with the second token's
match nibble, offset and extension.  Only the joined block's end keeps the
end-of-block rules, as it must.  The join is valid when no match of a
payload reaches before the joined block's start: independent payloads
(kernels B and I), or a linked chain started without a prefix (kernel A),
whose offsets stay within 65,535 bytes of their position.

``merge_payloads`` finds each payload's terminal sequence by walking its
tokens, or takes it from the encoder (the ``tails`` of
``encode_blocks_linked`` and ``encode_blocks_hc``), and then copies each
payload in a few slices.
"""

from __future__ import annotations

from typing import Optional, Sequence


def _ext(payload, ip: int, run: int):
    """Add a length extension at ``ip`` to ``run``: (run, next ip)."""
    while True:
        b = payload[ip]
        ip += 1
        run += b
        if b != 255:
            return run, ip


def _literal_run(payload, ip: int):
    """(literal run of the token at ``ip``, offset of its literals)."""
    run, ip = payload[ip] >> 4, ip + 1
    if run == 15:
        run, ip = _ext(payload, ip, run)
    return run, ip


def literal_head(n: int, match_nibble: int = 0) -> bytes:
    """Token and literal-length extension of a sequence with ``n``
    literals."""
    head = bytearray([min(n, 15) << 4 | match_nibble])
    if n >= 15:
        rest = n - 15
        head += b"\xff" * (rest // 255) + bytes([rest % 255])
    return bytes(head)


def terminal_literals(payload) -> int:
    """Offset of the token of a block's last (literal-only) sequence, by a
    walk over its tokens."""
    ip, n = 0, len(payload)
    while True:
        at = ip
        token = payload[ip]
        run, ip = _literal_run(payload, ip)
        ip += run
        if ip >= n:
            return at
        ip += 2
        if token & 15 == 15:
            _, ip = _ext(payload, ip, 0)


def merge_payloads(payloads: Sequence,
                   tails: Optional[Sequence[int]] = None) -> bytes:
    """One LZ4 block decoding to the concatenation of the contents of
    ``payloads`` (compressed blocks, in order, bytes or memoryviews).
    ``tails[k]``, when given, is the offset of payload k's terminal token
    (``terminal_literals(payloads[k])`` otherwise); 0 marks a payload that
    is one literal-only sequence, whose literals join the run."""
    out = []
    carry, carried = [], 0      # literals of the pending terminal runs
    for k, p in enumerate(payloads):
        t = terminal_literals(p) if tails is None else int(tails[k])
        run, ip = _literal_run(p, 0)
        if t == 0:                              # one literal-only sequence
            carry.append(p[ip:ip + run])
            carried += run
            continue
        out.append(literal_head(carried + run, p[0] & 15))
        out += carry
        out.append(p[ip:t])
        run, ip = _literal_run(p, t)
        carry, carried = [p[ip:ip + run]], run
    out.append(literal_head(carried))
    out += carry
    return b"".join(out)


def merged_blocks(records, group: int):
    """Merge every ``group`` consecutive records (payload, stored) into one
    block; a stored record takes part as a literal-only block."""
    payloads = [literal_head(len(p)) + p if st else p for p, st in records]
    return [merge_payloads(payloads[i:i + group])
            for i in range(0, len(payloads), group)]
