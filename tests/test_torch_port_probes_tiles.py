"""The kernel bench's tile-product probes and ``softmax_only`` against the
JAX package's, on the CPU (see ``test_torch_port_probes.py``).

Tile products: 1e-5·max|O| in f32, 4e-3·max|O| in bf16 (S is rounded to
bf16 between the two products; summing in another order can flip one
rounding). ``softmax_only``: 1e-5; the port runs the masked softmax on the
two diagonal unit blocks that reach the output, and every other entry is
exactly 0 on both sides.
"""

import pytest

from test_torch_port_probes import check_probe

TILES = ["mm_nt", "mm_nt_bf16", "mm_split_bf16", "mm_nt_split", "mm_dot1_bf16", "mm_dot1_nt",
         "floor_dot1slim_bf16", "floor_puredot1slim", "floor_bigm_bf16", "floor_purebigm",
         "floor_sn256_bf16", "floor_puresn256", "tlay_mm", "tlay_mm_bf16", "mix_mm", "tmx_mm",
         "tmq_mm", "tmq_bmm", "matmul_only", "matmul_k128", "matmul_only_bf16"]


@pytest.mark.parametrize("impl", TILES)
def test_tile_product_probes_match_jax(impl, monkeypatch):
    check_probe(impl, monkeypatch, "tile")


def test_softmax_only_matches_jax(monkeypatch):
    assert check_probe("softmax_only", monkeypatch, 1e-5) <= 1e-5
