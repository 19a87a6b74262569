"""repro_torch's balanced batching (``data/balanced.py``) against
repro's ``repro.data.balanced``: the documents' MBRs, ``balanced_bins``
over the port's partitioners and ``naive_bins``, bit for bit on the
lengths of ``tests/test_substrate.py`` (``doc_lengths(0, 2048, 8192)``)
and on a short skewed set, for slc (the default), bsp and str."""
import os, sys  # noqa: E401
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "port"))

import numpy as np
import pytest
import torch

from repro.data import balanced as jbal
from repro.data import tokens as jtokens
from repro_torch.data import balanced, tokens

torch.set_num_threads(1)


def _lengths(case):
    if case == "substrate":
        return jtokens.doc_lengths(0, 2048, 8192)
    rng = np.random.default_rng(4)
    return np.where(rng.random(300) < 0.05, 6000,
                    rng.integers(1, 200, 300)).astype(np.int64)


@pytest.mark.parametrize("case", ["substrate", "skewed"])
def test_docs_as_mbrs_and_lengths(case):
    lengths = _lengths(case)
    if case == "substrate":
        np.testing.assert_array_equal(tokens.doc_lengths(0, 2048, 8192),
                                      lengths)
    got = balanced.docs_as_mbrs(lengths, "cpu")
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jbal.docs_as_mbrs(lengths)))


@pytest.mark.parametrize("method", ["slc", "bsp", "str"])
@pytest.mark.parametrize("n_bins", [16, 7])
@pytest.mark.parametrize("case", ["substrate", "skewed"])
def test_balanced_bins_bit_for_bit(case, n_bins, method):
    lengths = _lengths(case)
    got, stats = balanced.balanced_bins(lengths, n_bins, method, "cpu")
    want, wstats = jbal.balanced_bins(lengths, n_bins, method)
    np.testing.assert_array_equal(got, want)
    assert stats == wstats


@pytest.mark.parametrize("n_bins", [16, 7])
@pytest.mark.parametrize("case", ["substrate", "skewed"])
def test_naive_bins_bit_for_bit_and_balanced_beats_it(case, n_bins):
    lengths = _lengths(case)
    got, stats = balanced.naive_bins(lengths, n_bins)
    want, wstats = jbal.naive_bins(lengths, n_bins)
    np.testing.assert_array_equal(got, want)
    assert stats == wstats
    if case == "substrate":     # tests/test_substrate.py's claim
        _, bal = balanced.balanced_bins(lengths, n_bins, device="cpu")
        assert bal["skew"] < stats["skew"]
