"""The ctypes signatures the port's wrappers bind hold the C entry points of
``sl_hwgat_tpu_torch/csrc``: as many arguments, each of the type ctypes
passes (a pointer, a 64-bit or 32-bit integer, a float). A wrapper whose
list falls behind its kernel's declaration would pass its arguments in the
wrong places on the card, where nothing here runs; this holds them
together on the CPU. The ablation bench's entry for the banded forward's
earlier design keeps that design's signature."""

import re

import pytest

from sl_hwgat_tpu_torch.bench import ablate
from sl_hwgat_tpu_torch.ops import _build
from sl_hwgat_tpu_torch.ops import banded_attention as ba
from sl_hwgat_tpu_torch.ops import hybrid_attention as ha
from sl_hwgat_tpu_torch.ops import probes
from sl_hwgat_tpu_torch.ops import window_attention as wa

_C_TYPES = {"void*": "p", "long long": "ll", "int": "i", "float": "f"}
BOUND = {name: types for mod in (wa, ba, ha, probes) for name, types in mod._ARGTYPES.items()}


def c_signature(name: str) -> list[str]:
    """The argument types of ``extern "C" int name(...)`` in its source, as
    the wrappers' codes ("p", "ll", "i", "f")."""
    text = (_build.CSRC_DIR / f"{name}.cu").read_text()
    m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", text)
    assert m, name
    codes = []
    for arg in m.group(1).split(","):
        decl = " ".join(arg.replace("const ", "").split()[:-1])
        decl = "void*" if decl.endswith("*") else decl
        codes.append(_C_TYPES[decl])
    return codes


@pytest.mark.parametrize("name", sorted(BOUND))
def test_wrapper_argtypes_match_the_c_entry(name):
    assert name in _build.SOURCES
    assert BOUND[name] == c_signature(name)


def test_every_source_has_a_bound_entry():
    assert set(BOUND) == set(_build.SOURCES)


def test_the_banded_forward_takes_the_bands_edge_count_before_the_scale():
    """The forward sizes its cache of scores by ``edges_per_row``; the
    earlier design's entry (timed by ``bench.ablate banded_fwd --parent``)
    had no such argument."""
    new, old = c_signature(ba.KERNEL), ablate._ARGTYPES_OF[(ba.KERNEL, "recompute")]
    assert new[:11] + new[12:] == old and new[11] == "i"


# The block helpers that chip_smoke.py reads (``redesigned_blocks``): how
# many int arguments it passes before the two int* outputs.
BLOCK_INPUTS = {"masked_softmax_fwd": 3, "masked_softmax_bwd": 3, "window_attention_bwd": 2,
                "window_attention_fwd": 2, "banded_attention_fwd": 3, "banded_attention_bwd": 3,
                "tile_matmul": 5, "window_attention_layout": 2, "softmax_probe": 0,
                "window_attention_layout_bwd": 2, "relayout": 1}


def block_signature(name: str) -> list[str]:
    text = (_build.CSRC_DIR / f"{name}.cu").read_text()
    m = re.search(r'extern "C" int ' + name + r"_block\(([^)]*)\)", text)
    assert m, name
    return [" ".join(arg.split()[:-1]) for arg in m.group(1).split(",")]


@pytest.mark.parametrize("name", sorted(BLOCK_INPUTS))
def test_block_helpers_take_ints_then_two_outputs(name):
    assert block_signature(name) == ["int"] * BLOCK_INPUTS[name] + ["int*", "int*"]


def test_chip_smoke_reads_a_block_of_every_redesigned_kernel():
    """Each REDESIGNED source has a block helper, and the tile products'
    cases give it (rows, depth, columns, mode) before the input type."""
    import chip_smoke

    assert set(chip_smoke.REDESIGNED) == set(BLOCK_INPUTS)
    for rows, depth, cols, mode in chip_smoke.TILE_BLOCKS.values():
        assert cols <= rows <= probes.MAX_ROWS and depth <= probes.MAX_DEPTH and mode in (0, 1)
