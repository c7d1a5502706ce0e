"""The IPM loop's paths bit for bit against recorded outputs
(``tests/data_torch_loop_golden.npz``, written by
``tests/make_torch_loop_golden.py``): each case runs one path of the dense,
diagonal, banded or general tier, or a gradient through the dense layer,
on the CPU at B = 6 and n <= 12, and every array it returns must equal the
recorded one exactly (``torch.equal``; NaN where the recording has NaN).
Each path also leaves no reference cycle behind: what a solve made is
freed when it returns, not when the garbage collector next runs (on the
card, that is device memory)."""

import gc

import numpy as np
import pytest
import torch

from make_torch_loop_golden import CASES, DATA, outputs


@pytest.fixture(scope="module")
def golden():
    with np.load(DATA) as f:
        return {k: f[k] for k in f.files}


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", list(CASES))
def test_loop_path_is_bit_identical(name, golden, one_thread):
    got = outputs(name)
    want = {k.split("/", 1)[1]: v for k, v in golden.items()
            if k.split("/", 1)[0] == name}
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        w = torch.from_numpy(want[k])
        v = v.detach()
        assert v.dtype == w.dtype and v.shape == w.shape, k
        nan = torch.isnan(w) if w.is_floating_point() else None
        if nan is not None and bool(nan.any()):
            assert torch.equal(torch.isnan(v), nan), k
            v, w = v[~nan], w[~nan]
        assert torch.equal(v, w), (name, k)


@pytest.mark.parametrize("name", list(CASES))
def test_loop_path_leaves_no_reference_cycle(name, one_thread):
    outputs(name)
    gc.collect()
    gc.disable()
    try:
        outputs(name)
        found = gc.collect()
    finally:
        gc.enable()
    assert found == 0, (name, found)
