"""The 3-container docker flow, end-to-end without docker.

docker/bin/{start-preprocess.sh, start-cluster.sh, start-client.sh}
(parity: reference docker/bin/*) each boil down to one apsim command over
shared volumes:

    preprocess:  apsim etl /root/data --store /root/store --table T
    cluster:     apsim serve --host .. --port .. --store /root/store
    client:      apsim client --remote compute-node-0:2551  (start/test/quit)

This test runs exactly those three stages in-process against a tmp "volume"
— the compose-level smoke the scripts promise — and additionally checks
every shipped shell script parses (bash -n)."""

import glob
import io
import os
import subprocess
import time

import pytest

from apsim import AllPairsConfig, Engine
from apsim.cli import main as cli_main
from apsim.etl.store import VectorStore
from apsim.serve import (
    ClientConnection,
    InteractiveClient,
    RpcServer,
    SimilarityServer,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def corpus_dir(tmp_path):
    d = tmp_path / "corpus" / "inbox"
    d.mkdir(parents=True)
    (d / "1.").write_text("alpha beta gamma alpha")
    (d / "2.").write_text("alpha beta gamma alpha")
    (d / "3.").write_text("delta epsilon zeta")
    (d / "4.").write_text("alpha beta gamma")
    return str(tmp_path / "corpus")


def test_three_container_flow(tmp_path, corpus_dir):
    store_dir = str(tmp_path / "store")

    # stage 1 — start-preprocess.sh: corpus -> TF-IDF -> store volume
    rc = cli_main([
        "etl", corpus_dir, "--store", store_dir, "--table", "SMALL_DATA",
        "--vector-dim", "4096",
    ])
    assert rc == 0

    # stage 2 — start-cluster.sh: one serve process with the store mounted
    cfg = AllPairsConfig(
        vector_dim=4096, query_tile=64, row_bucket=64, dim_bucket=64,
        similarity_threshold=0.5, io_trigger_period_ms=5,
    )
    store = VectorStore(store_dir)
    n_rows = store.read("SMALL_DATA")[0].n_rows
    with SimilarityServer(Engine(cfg), cfg, store=store) as srv:
        outputs = []
        srv.add_output_sink(lambda o: outputs.append(o))
        with RpcServer(srv, host="127.0.0.1", port=0) as rpc:
            # stage 3 — start-client.sh: the interactive terminal issuing
            # the reference's start/test/quit loop (Client.scala:61-94)
            cc = ClientConnection([f"127.0.0.1:{rpc.port}"])
            out = io.StringIO()
            InteractiveClient(cc, out=out).run(input_lines=[
                "test", "ping",
                "start", "SMALL_DATA", "0", str(n_rows - 1),
                "quit",
            ])
            cc.close()
            assert "test reply" in out.getvalue()
            deadline = time.time() + 10
            while time.time() < deadline:
                if srv.stats()["n_rows"] == n_rows:
                    break
                time.sleep(0.05)
            assert srv.stats()["n_rows"] == n_rows
            srv.flush()
    # docs 1. and 2. are identical -> at least that pair found
    emitted = set()
    for o in outputs:
        for q, sims in o.output.items():
            for c in sims:
                emitted.add((q, c) if q <= c else (c, q))
    assert any("inbox/1." in a and "inbox/2." in b for a, b in emitted)


def test_shell_scripts_parse():
    """bash -n every shipped ops script (sbin/ + docker/bin/)."""
    scripts = sorted(
        glob.glob(os.path.join(REPO, "sbin", "*.sh"))
        + glob.glob(os.path.join(REPO, "docker", "bin", "*.sh"))
    )
    assert len(scripts) >= 8, scripts  # 4 sbin + 1 cluster extra + 4 docker
    for s in scripts:
        r = subprocess.run(
            ["bash", "-n", s], capture_output=True, text=True, timeout=30
        )
        assert r.returncode == 0, (s, r.stderr)


def test_docker_scripts_reference_parity():
    """The reference ships start-cluster/start-client/start-preprocess
    (docker/bin/*.sh) — all three analogs must exist and be executable
    bash with the documented volume contract."""
    for name in ("start-cluster.sh", "start-client.sh",
                 "start-preprocess.sh", "stop-cluster.sh"):
        p = os.path.join(REPO, "docker", "bin", name)
        assert os.path.exists(p), name
        text = open(p).read()
        assert text.startswith("#!"), name
    # shared volume contract: preprocess writes where cluster+client mount
    for name in ("start-cluster.sh", "start-client.sh",
                 "start-preprocess.sh"):
        text = open(os.path.join(REPO, "docker", "bin", name)).read()
        assert "APSIM_STORE" in text, name
        assert "/root/store" in text, name
