"""The wide backward's table reduce (``ops/fused_grad.py:row_reduce``, the
sum K6, K7 and K8 end with) on the CPU: its plain version against a NumPy
float64 ``np.add.at`` reference on the synthetic key sets the card checks
the kernels with, the -1 drop, the zero sums of a launch without winners,
and the mapping of rows into ``d_objtx`` rows 0-2 and ``d_prim``.  The
kernels themselves run on the card (``test_torch_cuda.py``,
``chip_smoke.py`` phase 15)."""

import numpy as np
import pytest
import torch

from pyrayt_tpu_torch.ops import fused_grad as fg
from torch_parity_scenes import reduce_inputs, reduce_key_sets

KEY_SETS = reduce_key_sets(5000)
DTYPES = [torch.float64, torch.float32]


def reference(keys, vals, rows):
    """(rows, 18) float64 sums by np.add.at over the entries with a row."""
    k = keys.numpy()
    v = vals.double().numpy()
    out = np.zeros((rows, 18))
    np.add.at(out, k[k >= 0], v[k >= 0])
    return out


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", sorted(KEY_SETS))
def test_plain_matches_numpy(name, dtype):
    keys_np, rows = KEY_SETS[name]
    keys, vals, slots = reduce_inputs(keys_np, rows, dtype, "cpu")
    d_obj, d_prim = fg.row_reduce_plain(keys, vals, slots, rows, rows + 3)
    assert d_obj.dtype == dtype and d_obj.shape == (rows + 3, 16) and d_prim.shape == (rows + 3, 6)
    ref = reference(keys, vals, rows)
    got = np.concatenate((d_obj[slots.long(), :12].double().numpy(),
                          d_prim[slots.long()].double().numpy()), axis=1)
    # float64: the same sum in another order; float32: one rounding of it
    rtol = 1e-12 if dtype == torch.float64 else 1e-6
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * max(1.0, np.abs(ref).max()))


@pytest.mark.parametrize("dtype", DTYPES)
def test_minus_one_entries_drop_out(dtype):
    """Entries keyed -1 carry NaN values; no sum reads them, and changing
    them changes nothing."""
    keys_np, rows = KEY_SETS["detector_skew"]
    keys, vals, slots = reduce_inputs(keys_np, rows, dtype, "cpu")
    first = fg.row_reduce_plain(keys, vals, slots, rows, rows + 3)
    assert (keys < 0).any() and torch.isnan(vals[keys < 0]).all()
    vals[keys < 0] = 1e30
    second = fg.row_reduce_plain(keys, vals, slots, rows, rows + 3)
    for a, b in zip(first, second):
        assert torch.isfinite(a).all() and torch.equal(a, b)


@pytest.mark.parametrize("dtype", DTYPES)
def test_no_winner_gives_zero_sums(dtype):
    keys_np, rows = KEY_SETS["all_minus_one"]
    keys, vals, slots = reduce_inputs(keys_np, rows, dtype, "cpu")
    for d in fg.row_reduce(keys, vals, slots, rows, rows + 3):
        assert d.dtype == dtype and not d.any()


@pytest.mark.parametrize("dtype", DTYPES)
def test_rows_map_into_their_slots(dtype):
    """Row r's 18 sums land in rows 0-2 of d_objtx[reduce_slots[r]] (row 3
    stays zero) and in d_prim[reduce_slots[r]]; other slots stay zero."""
    rows, n_slots = 3, 7
    keys = torch.tensor([0, 2, -1, 2, 1, 0], dtype=torch.int32)
    vals = torch.arange(6 * 18, dtype=dtype).reshape(6, 18)
    slots = torch.tensor([5, 0, 3], dtype=torch.int32)
    d_obj, d_prim = fg.row_reduce_plain(keys, vals, slots, rows, n_slots)
    sums = {0: vals[0] + vals[5], 1: vals[4], 2: vals[1] + vals[3]}
    for r, s in enumerate(slots.tolist()):
        assert torch.equal(d_obj[s, :12], sums[r][:12])
        assert torch.equal(d_prim[s], sums[r][12:])
        assert not d_obj[s, 12:].any()
    for s in set(range(n_slots)) - set(slots.tolist()):
        assert not d_obj[s].any() and not d_prim[s].any()


def test_cpu_wrapper_runs_the_plain_version_uncounted():
    keys_np, rows = KEY_SETS["ragged"]
    keys, vals, slots = reduce_inputs(keys_np, rows, torch.float64, "cpu")
    before = fg.row_reduce.launches
    got = fg.row_reduce(keys, vals, slots, rows, rows + 3)
    want = fg.row_reduce_plain(keys, vals, slots, rows, rows + 3)
    assert fg.row_reduce.launches == before
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert got[0].shape == (rows + 3, 16)


@pytest.mark.parametrize("case", ["key_past_rows", "vals_layout", "slots_length", "slot_past_end"])
def test_bad_inputs_raise(case):
    keys, vals, slots = reduce_inputs(np.array([0, 1, -1, 2]), 3, torch.float64, "cpu")
    n_slots = 6
    if case == "key_past_rows":
        keys[0] = 3
    elif case == "vals_layout":
        vals = vals.T.contiguous()
    elif case == "slots_length":
        slots = slots[:2]
    else:
        n_slots = int(slots.max())
    with pytest.raises(ValueError):
        fg.row_reduce_plain(keys, vals, slots, 3, n_slots)


def test_table_layout_and_scratch_limits():
    """The kernels' table is entry-major, (..., 18) values beside (...)
    int32 keys, and a reduce past the library's limits (its scratch helper
    returns -1) raises before any launch."""
    keys, vals = fg._reduce_table((4, 7), torch.float32, "cpu")
    assert keys.dtype == torch.int32 and keys.shape == (4, 7)
    assert vals.shape == (4, 7, 18) and vals.is_contiguous()
    with pytest.raises(ValueError, match="51200 rows"):
        fg._reduce_scratch(lambda n, rows: -1, 10, 60000, "cpu")
    assert fg._reduce_scratch(lambda n, rows: 512, 10, 3, "cpu").numel() == 512
