"""The work of the LoFTR teacher's coarse model (`models/loftr_native.py`
over `loftr_teacher.npz`: C = 32, the backbone below, 4 encoder layers), in
products only, 2 per multiply-add, counted at each call's own shapes from
the hooks' records of the traced window (`port.Hooks.loftr_encodes`,
`loftr_confidences`). Its products run at the card's bf16 peak.

`encode_flops` and `pair_flops` are the arithmetic that `bounds.py` held
before model work moved into files of its own, unchanged.
"""

from __future__ import annotations

import collections

C = 32
BACKBONE = (  # (cin, cout, kernel, stride) in order, as Backbone builds it
    (1, 8, 7, 2),
    (8, 8, 3, 1), (8, 8, 3, 1), (8, 8, 3, 1), (8, 8, 3, 1),
    (8, 16, 3, 2), (16, 16, 3, 1), (8, 16, 1, 2), (16, 16, 3, 1), (16, 16, 3, 1),
    (16, 32, 3, 2), (32, 32, 3, 1), (16, 32, 1, 2), (32, 32, 3, 1), (32, 32, 3, 1),
    (32, 32, 3, 2), (32, 32, 3, 1), (32, 32, 1, 2), (32, 32, 3, 1), (32, 32, 3, 1),
    (32, 32, 1, 1),
)


def encode_flops(h: int, w: int) -> float:
    """Products of one h x w image's backbone. The stride-2 entries halve
    the grid the convolutions after them run on; a 1x1 `down` runs on the
    block's output grid."""
    total = 0.0
    hh, ww = h, w
    for cin, cout, k, stride in BACKBONE:
        if stride == 2 and k != 1:
            hh, ww = -(-hh // 2), -(-ww // 2)
        total += 2.0 * cin * cout * k * k * hh * ww
    return total


def pair_flops(n_cells: int) -> float:
    """Products of one pair of n_cells tokens through the 4 encoder layers
    (each applied to both feature sets) and the similarity: q, k, v, merge
    (4 L C^2), kv (L C^2), the normalizer (L C), the message (L C^2), the
    MLP (L (2C)^2 + L 2C C), each times 2; then the L x L x C similarity."""
    L, c = n_cells, C
    per_apply = 2.0 * (4 * L * c * c + L * c * c + L * c + L * c * c + L * 4 * c * c + L * 2 * c * c)
    return 4 * 2 * per_apply + 2.0 * L * L * c


def flops(hooks) -> float:
    """Products of every encode and confidence call the hooks recorded,
    counted per shape: images x encode_flops, pairs x pair_flops."""
    images: collections.Counter = collections.Counter()
    pairs: collections.Counter = collections.Counter()
    for n, h, w in hooks.loftr_encodes:
        images[(h, w)] += n
    for n, tokens in hooks.loftr_confidences:
        pairs[tokens] += n
    return (sum(n * encode_flops(h, w) for (h, w), n in images.items())
            + sum(n * pair_flops(tokens) for tokens, n in pairs.items()))
