"""Config system tests (reference: HOCON layering,
SimilaritySearchService.scala:20-22)."""

import json

from apsim.config import AllPairsConfig, load_config


def test_defaults_match_reference():
    cfg = AllPairsConfig()
    assert cfg.vector_dim == 1 << 20          # conf/app.conf:6
    assert cfg.similarity_threshold == 0.7    # conf/app.conf:15
    assert cfg.max_shard_num == 10
    assert cfg.io_trigger_period_ms == 10     # conf/app.conf:9
    assert cfg.run_mode == "DEBUG"


def test_reference_key_aliases():
    cfg = AllPairsConfig.from_dict(
        {"vectorDim": 1024, "similarityThreshold": 0.5, "ioTriggerPeriod": 50}
    )
    assert cfg.vector_dim == 1024
    assert cfg.similarity_threshold == 0.5
    assert cfg.io_trigger_period_ms == 50


def test_nested_hocon_shape():
    # cpslab.allpair.* nesting flattens transparently
    cfg = AllPairsConfig.from_dict(
        {"cpslab": {"allpair": {"vectorDim": 2048,
                                "benchmark": {"expDuration": 1000}}}}
    )
    assert cfg.vector_dim == 2048
    assert cfg.bench_exp_duration_ms == 1000


def test_layered_load(tmp_path):
    a = tmp_path / "a.json"
    b = tmp_path / "b.json"
    a.write_text(json.dumps({"vectorDim": 100, "similarityThreshold": 0.9}))
    b.write_text(json.dumps({"similarityThreshold": 0.6}))
    cfg = load_config(str(a), str(b), overrides={"query_tile": 256})
    assert cfg.vector_dim == 100          # from a
    assert cfg.similarity_threshold == 0.6  # b overrides a
    assert cfg.query_tile == 256          # overrides win last


def test_unknown_keys_ignored():
    cfg = AllPairsConfig.from_dict({"zooKeeperQuorum": "master", "hdfs": "x"})
    assert cfg.vector_dim == 1 << 20
