"""The block-format constants of ``lz4_tpu_torch.spec`` equal
``lz4_tpu.spec``'s, and the modules that use them take them from there."""

import pytest

import lz4_tpu.spec as jspec
import lz4_tpu_torch.spec as tspec
from lz4_tpu_torch import block, hc

BLOCK_FORMAT = ["MINMATCH", "ML_BITS", "ML_MASK", "RUN_BITS", "RUN_MASK",
                "MAX_DISTANCE", "LASTLITERALS", "MFLIMIT", "LZ4_MINLENGTH"]


@pytest.mark.parametrize("name", BLOCK_FORMAT)
def test_block_format_constant_equals_jax(name):
    assert getattr(tspec, name) == getattr(jspec, name)


def test_block_and_hc_take_the_constants_from_spec():
    assert block.MINMATCH is tspec.MINMATCH
    assert not hasattr(hc, "LASTLITERALS")
    assert hc.spec is tspec
