"""chip_smoke.py's phases at tiny sizes on the CPU.

The script itself refuses to run without a GPU; its phases are
importable functions that take their sizes, so the same code is
rehearsed here.  The ``gpu``-marked test runs them at a real width on
the card.
"""

import pytest

import chip_smoke


def test_main_refuses_without_gpu(monkeypatch, tmp_path, capsys):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    with pytest.raises(RuntimeError, match="no GPU"):
        chip_smoke.main([])
    assert '"ok"' not in capsys.readouterr().out


def test_phases_tiny(capsys):
    chip_smoke.run(n_corpus=4096, n_queries=64, dim=16, hidden=(32, 32),
                   hash_size=3, n_sub=1024, steps=6, batch_size=128,
                   n_parity=32, mt_tables=2, canary_rows=4096, four=False,
                   n_shard_queries=0)
    out = capsys.readouterr().out
    for name in ("gather", "train", "build", "serve", "persist"):
        assert f"[{name}] ok" in out, out
    assert out.count("parity ok") == 2 * len(chip_smoke.ENGINE_LAYOUTS)


def test_four_paths_tiny(capsys):
    """The four-device phase on four virtual CPU devices: data-parallel
    losses, corpus-sharded and table-sharded answers against one
    device."""
    chip_smoke.run(n_corpus=4096, n_queries=64, dim=16, hidden=(32, 32),
                   hash_size=3, n_sub=1024, steps=4, batch_size=128,
                   n_parity=0, mt_tables=0, canary_rows=None, four=True,
                   n_shard_queries=64)
    out = capsys.readouterr().out
    assert "[four] ok" in out, out


def test_parity_rule_rejects_a_wrong_id():
    import numpy as np

    rng = np.random.default_rng(0)
    corpus = rng.normal(size=(50, 8))
    q = rng.normal(size=(1, 8))
    cands = [np.arange(50)]
    rows = lambda r: corpus[r]  # noqa: E731
    score = chip_smoke.reference_scores(corpus, q[0], "cosine", False)
    best = np.argsort(-score)[: chip_smoke.K]
    assert chip_smoke.check_parity("ok", best[None], cands, rows, q,
                                   "cosine", False) == 0
    wrong = best.copy()
    wrong[-1] = np.argsort(-score)[-1]  # the farthest row
    with pytest.raises(AssertionError, match="k-th"):
        chip_smoke.check_parity("bad", wrong[None], cands, rows, q,
                                "cosine", False)


@pytest.mark.gpu
def test_phases_on_gpu(gpu_device):
    """Every engine and layout at the flagship width and depth on a
    65k-row corpus: parity with the float64 rerank, recall, persistence
    and CLIs on the card."""
    chip_smoke.run(n_corpus=65_536, n_queries=1024, dim=100,
                   hidden=(256, 256), hash_size=7, n_sub=16_384, steps=8,
                   batch_size=1024, n_parity=256, mt_tables=4,
                   canary_rows=None, four=False, n_shard_queries=0)
