"""The port's data pipeline and matching packer (``repro_torch.data``) on the
CPU against the JAX package's, on the same configs and seeded documents.
Tolerance: exact equality (documents, token rows, loss masks and candidate
edges are integers). The reference's own ``test_data.py`` cases are
restated on the port, its property test on fewer examples."""
import numpy as np
import pytest
import torch

from strategies import given, settings, st  # noqa: E402

from repro.data import packing as j_packing
from repro.data import pipeline as j_pipeline
from repro_torch.data import (
    DataConfig,
    batch_for_step,
    documents_for_step,
    pack_documents,
    packing_efficiency,
    stream,
)
from repro_torch.data import packing


def configs(pack, host):
    kw = dict(vocab_size=1000, seq_len=128, batch_per_host=4, num_hosts=2,
              host_id=host, pack=pack)
    return DataConfig(**kw), j_pipeline.DataConfig(**kw)


@pytest.mark.parametrize("host", [0, 1])
@pytest.mark.parametrize("pack", [True, False])
def test_batches_equal_reference(pack, host):
    cfg, jcfg = configs(pack, host)
    for step in range(5):
        docs = documents_for_step(step, cfg, 8)
        jdocs = j_pipeline.documents_for_step(step, jcfg, 8)
        assert len(docs) == len(jdocs)
        for a, b in zip(docs, jdocs):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        rows, mask = batch_for_step(step, cfg, device="cpu")
        jrows, jmask = j_pipeline.batch_for_step(step, jcfg)
        assert rows.dtype == jrows.dtype and mask.dtype == jmask.dtype
        assert np.array_equal(rows, jrows) and np.array_equal(mask, jmask)


def test_stream_equals_batches():
    cfg, _ = configs(True, 0)
    it = stream(cfg, start_step=2, device="cpu")
    for step in (2, 3):
        rows, mask = next(it)
        want = batch_for_step(step, cfg, device="cpu")
        assert np.array_equal(rows, want[0]) and np.array_equal(mask, want[1])


@pytest.mark.parametrize("seed,n_docs,seq_len", [
    (0, 16, 128), (1, 32, 128), (2, 40, 64), (3, 1, 256), (4, 7, 256)])
def test_pack_documents_equals_reference(seed, n_docs, seq_len):
    rng = np.random.default_rng(seed)
    docs = [rng.integers(1, 100, size=int(n)).astype(np.int32)
            for n in rng.integers(8, seq_len, size=n_docs)]
    lengths = np.asarray([len(d) for d in docs])
    u, v = packing._candidate_edges(lengths, seq_len)
    ju, jv = j_packing._candidate_edges(lengths, seq_len)
    assert np.array_equal(u, ju) and np.array_equal(v, jv)
    assert u.dtype == ju.dtype == np.int32
    rows, mask = pack_documents(docs, n_docs // 2 + 1, seq_len, device="cpu")
    jrows, jmask = j_packing.pack_documents(docs, n_docs // 2 + 1, seq_len)
    assert np.array_equal(rows, jrows) and np.array_equal(mask, jmask)


def test_packer_defaults_to_the_card(monkeypatch):
    """``pack_documents`` (and a packed ``batch_for_step``) match on the
    card unless given the CPU, and raise without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    docs = [np.arange(1, 10, dtype=np.int32)] * 4
    with pytest.raises(RuntimeError, match="no CUDA device: pack_documents"):
        pack_documents(docs, 2, 32)
    cfg, _ = configs(True, 0)
    with pytest.raises(RuntimeError, match="no CUDA device: pack_documents"):
        batch_for_step(0, cfg)
    rows, _ = batch_for_step(0, configs(False, 0)[0])   # no packing
    assert rows.shape == (4, 128)


# ---------------------------------------- the reference's test_data.py ----
def test_batches_deterministic():
    cfg = DataConfig(vocab_size=1000, seq_len=128, batch_per_host=4)
    a1, m1 = batch_for_step(7, cfg, device="cpu")
    a2, m2 = batch_for_step(7, cfg, device="cpu")
    np.testing.assert_array_equal(a1, a2)
    np.testing.assert_array_equal(m1, m2)


def test_hosts_get_disjoint_streams():
    a0, _ = batch_for_step(3, configs(True, 0)[0], device="cpu")
    a1, _ = batch_for_step(3, configs(True, 1)[0], device="cpu")
    assert not np.array_equal(a0, a1)


def test_steps_differ():
    cfg = DataConfig(vocab_size=1000, seq_len=128, batch_per_host=4)
    a0, _ = batch_for_step(0, cfg, device="cpu")
    a1, _ = batch_for_step(1, cfg, device="cpu")
    assert not np.array_equal(a0, a1)


def test_pack_documents_valid():
    rng = np.random.default_rng(0)
    docs = [rng.integers(1, 100, size=rng.integers(10, 100)).astype(np.int32)
            for _ in range(16)]
    rows, mask = pack_documents(docs, 8, 128, device="cpu")
    assert rows.shape == (8, 128)
    assert mask.shape == (8, 128)
    assert (rows[~mask] == 0).all()       # tokens only where mask
    assert (rows[mask] > 0).all()


def test_packing_beats_one_doc_per_row():
    rng = np.random.default_rng(1)
    docs = [rng.integers(1, 100, size=int(n)).astype(np.int32)
            for n in rng.integers(20, 120, size=32)]
    _, mask_packed = pack_documents(docs, 16, 128, device="cpu")
    mask_plain = np.zeros((16, 128), bool)
    for i in range(16):
        mask_plain[i, : min(len(docs[i]), 128)] = True
    assert packing_efficiency(mask_packed) > packing_efficiency(mask_plain)


@settings(max_examples=5, deadline=None)
@given(
    seed=st.integers(0, 2**31 - 1),
    n_docs=st.integers(1, 40),
    seq_len=st.sampled_from([64, 128, 256]),
)
def test_property_packing_never_splits_docs_across_rows(seed, n_docs,
                                                        seq_len):
    rng = np.random.default_rng(seed)
    docs = [rng.integers(1, 100, size=int(n)).astype(np.int32)
            for n in rng.integers(8, seq_len, size=n_docs)]
    rows, mask = pack_documents(docs, n_docs, seq_len, device="cpu")
    # each row's mask is a prefix (documents are packed head to tail)
    for r in range(rows.shape[0]):
        m = mask[r]
        if m.any():
            last = np.nonzero(m)[0].max()
            assert m[: last + 1].all()
