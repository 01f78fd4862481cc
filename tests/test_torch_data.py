"""The port's training streams (``repro_torch.data.pipeline``): the
reference's seven ``test_data.py`` properties on the port's streams
(determinism, the seed, disjoint host shards, exact restore, shifted
targets, EOS between packed documents, the memorization corpus), plus
the batches' dtype and device, the memorization corpus cycling with
``n_rows`` past the batch, and its restore.  The port draws with numpy's
Philox, not ``jax.random``: the tokens differ from the reference's, the
properties are its."""
import torch

from repro_torch.data.pipeline import MemorizationStream, SyntheticLMStream
from test_torch_threads import one_thread  # noqa: F401 (autouse)


def _lm(**kw) -> SyntheticLMStream:
    return SyntheticLMStream(device="cpu", **kw)


def test_deterministic():
    a = _lm(vocab_size=100, seq_len=32, global_batch=4, seed=1)
    b = _lm(vocab_size=100, seq_len=32, global_batch=4, seed=1)
    for _ in range(3):
        assert torch.equal(a.next()["tokens"], b.next()["tokens"])


def test_seed_changes_stream():
    a = _lm(vocab_size=100, seq_len=32, global_batch=4, seed=1)
    b = _lm(vocab_size=100, seq_len=32, global_batch=4, seed=2)
    assert not torch.equal(a.next()["tokens"], b.next()["tokens"])


def test_host_sharding_disjoint_union():
    """2 hosts x batch 2 == 1 host x batch 4, rows assigned by global id."""
    whole = _lm(vocab_size=50, seq_len=16, global_batch=4, n_hosts=1,
                host_id=0, seed=3)
    h0 = _lm(vocab_size=50, seq_len=16, global_batch=4, n_hosts=2,
             host_id=0, seed=3)
    h1 = _lm(vocab_size=50, seq_len=16, global_batch=4, n_hosts=2,
             host_id=1, seed=3)
    w, a, b = whole.next(), h0.next(), h1.next()
    assert torch.equal(w["tokens"][:2], a["tokens"])
    assert torch.equal(w["tokens"][2:], b["tokens"])


def test_restore_resumes_exactly():
    s = _lm(vocab_size=50, seq_len=16, global_batch=2, seed=9)
    s.next()
    s.next()
    saved = s.state()
    want = s.next()
    r = SyntheticLMStream.restore(saved, vocab_size=50, seq_len=16,
                                  global_batch=2, device="cpu")
    assert torch.equal(want["tokens"], r.next()["tokens"])


def test_targets_are_shifted_tokens():
    b = _lm(vocab_size=50, seq_len=16, global_batch=2, seed=4).next()
    assert torch.equal(b["tokens"][:, 1:], b["targets"][:, :-1])
    assert b["tokens"].dtype == b["targets"].dtype == torch.int64
    assert b["tokens"].device.type == "cpu"
    assert tuple(b["tokens"].shape) == (2, 16)


def test_packing_contains_eos_boundaries():
    s = _lm(vocab_size=50, seq_len=256, global_batch=1, seed=5,
            mean_doc_len=16)
    b = s.next()
    assert int((b["tokens"] == s.eos_id).sum()) > 2
    assert int(b["tokens"].min()) >= 0 and int(b["tokens"].max()) < 50


def test_memorization_stream_cycles():
    s = MemorizationStream(vocab_size=50, seq_len=8, batch=4, n_rows=4,
                           device="cpu")
    a = s.next()
    s2 = MemorizationStream(vocab_size=50, seq_len=8, batch=4, n_rows=4,
                            device="cpu")
    assert torch.equal(a["tokens"], s2.next()["tokens"])
    # with n_rows past the batch the rows wrap around the corpus
    s3 = MemorizationStream(vocab_size=50, seq_len=8, batch=3, n_rows=4,
                            device="cpu")
    rows = [s3.next()["tokens"] for _ in range(4)]
    assert torch.equal(torch.cat(rows), s3.corpus[:, :-1].repeat(3, 1))
    assert int(s3.corpus.min()) >= 1


def test_memorization_restore_resumes_exactly():
    s = MemorizationStream(vocab_size=50, seq_len=8, batch=3, n_rows=5,
                           seed=2, device="cpu")
    s.next()
    saved = s.state()
    want = s.next()
    r = MemorizationStream.restore(saved, vocab_size=50, seq_len=8, batch=3,
                                   n_rows=5, device="cpu")
    assert torch.equal(want["targets"], r.next()["targets"])
