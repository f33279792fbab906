"""Output/emission tests (reference: SimilarityOutput, Message.scala:20-35;
batched emission, IndexingWorkerActor.scala:122-141)."""

import time

import numpy as np

from apsim.engine.output import OutputBatcher, PairResult, SimilarityOutput


def _pair_result():
    return PairResult(
        i=np.array([0, 0, 1]),
        j=np.array([1, 2, 2]),
        sims=np.array([0.9, 0.8, 0.7]),
        ids=["a", "b", "c"],
    )


def test_pair_result_views():
    r = _pair_result()
    assert r.n_pairs == 3
    assert ("a", "b", 0.9) in r.id_pairs()
    assert r.pair_set() == {("a", "b"), ("a", "c"), ("b", "c")}
    so = r.to_similarity_output(symmetric=True)
    assert so.output["a"]["b"] == 0.9
    assert so.output["b"]["a"] == 0.9
    asym = r.to_similarity_output(symmetric=False)
    assert "a" not in asym.output.get("b", {})


def test_similarity_output_str():
    so = SimilarityOutput({"q": {"x": 0.5}}, 0.0)
    s = str(so)
    assert "q:" in s and "x,0.5;" in s and "---" in s


def test_batcher_immediate():
    got = []
    b = OutputBatcher(got.append, duration_ms=0)
    b.emit(SimilarityOutput({"q": {"x": 1.0}}, time.time()))
    assert len(got) == 1
    b.emit(SimilarityOutput({}, time.time()))  # empty not forwarded
    assert len(got) == 1
    b.close()


def test_batcher_coalesces():
    got = []
    b = OutputBatcher(got.append, duration_ms=50)
    b.emit(SimilarityOutput({"q": {"x": 1.0}}, time.time()))
    b.emit(SimilarityOutput({"q": {"y": 0.5}, "r": {"z": 0.4}}, time.time()))
    deadline = time.time() + 2.0
    while not got and time.time() < deadline:
        time.sleep(0.01)
    b.close()
    assert got, "timed flush never fired"
    merged = {}
    for so in got:
        so.merge_into(merged)
    assert merged == {"q": {"x": 1.0, "y": 0.5}, "r": {"z": 0.4}}
