"""ETL tests (reference: etl/src/main/scala/cpslab/etl/*)."""

import os

import numpy as np
import pytest

from apsim.etl.ccweb import parse_ccweb_line
from apsim.etl.corpus import iter_documents, list_corpus_files, read_document
from apsim.etl.store import (
    VectorStore,
    load_text_vectors,
    save_text_vectors,
    split_load_range,
)
from apsim.etl.tfidf import (
    apply_idf,
    hashing_tf,
    idf_weights,
    tfidf_pipeline,
    top_dim_filter,
)
from apsim.vector.batch import CSRMatrix
from apsim.vector.sparse import Vectors


@pytest.fixture
def corpus_dir(tmp_path):
    (tmp_path / "a" / "inbox").mkdir(parents=True)
    (tmp_path / "b").mkdir()
    (tmp_path / "a" / "inbox" / "1.").write_text("hello world\nsecond line")
    (tmp_path / "a" / "inbox" / ".DS_Store").write_text("junk")
    (tmp_path / "b" / "2.").write_text("hello again")
    return str(tmp_path)


def test_corpus_walk(corpus_dir):
    files = list_corpus_files(corpus_dir)
    assert len(files) == 2  # .DS_Store skipped (Utils.scala:19)
    assert all(".DS_Store" not in f for f in files)
    doc = read_document(files[0])
    assert doc == "hello world second line"  # one line per file
    docs = dict(iter_documents(corpus_dir))
    assert set(docs) == {os.path.join("a", "inbox", "1."), os.path.join("b", "2.")}


def test_hashing_tf_counts():
    tf = hashing_tf(["a b a", "b c"], num_features=1 << 12)
    assert tf.n_rows == 2
    # row 0 has two distinct terms with counts {a:2, b:1}
    assert sorted(tf.row(0).values.tolist()) == [1.0, 2.0]
    assert tf.row(1).nnz == 2


def test_idf_formula():
    tf = hashing_tf(["a", "a b"], num_features=1 << 12)
    idf = idf_weights(tf)
    # df(a)=2, df(b)=1, m=2 -> idf(a)=log(3/3)=0, idf(b)=log(3/2)
    vals = apply_idf(tf, idf)
    nonzero = vals.data[vals.data > 0]
    np.testing.assert_allclose(nonzero, [np.log(3.0 / 2.0)])


def test_tfidf_pipeline_normalized():
    csr = tfidf_pipeline(["x y z", "x q"], num_features=1 << 12)
    norms = csr.row_norms()
    for n in norms:
        assert n == pytest.approx(1.0) or n == 0.0


def test_top_dim_filter():
    csr = CSRMatrix.from_vectors(
        [
            Vectors.sparse(6, [0, 1], [5.0, 1.0]),
            Vectors.sparse(6, [1, 2], [2.0, 9.0]),
        ],
        6,
    )
    # keep top-2 dims by max weight: dim2 (9) and dim0 (5)
    f = top_dim_filter(csr, 2)
    assert set(f.indices.tolist()) == {0, 2}
    assert f.n_rows == 2
    # full passthrough when threshold >= n_cols
    assert top_dim_filter(csr, 100) is csr


def test_text_store_roundtrip(tmp_path):
    csr = CSRMatrix.from_vectors(
        [Vectors.sparse(8, [1, 5], [0.25, 1.5]), Vectors.sparse(8, [0], [2.0])], 8
    )
    p = str(tmp_path / "vecs.txt")
    save_text_vectors(p, csr)
    back = load_text_vectors(p)
    assert back.n_rows == 2
    np.testing.assert_allclose(back.data, csr.data)
    np.testing.assert_array_equal(back.indices, csr.indices)


def test_vector_store(tmp_path):
    store = VectorStore(str(tmp_path / "store"))
    csr = CSRMatrix.from_vectors(
        [Vectors.sparse(8, [i], [float(i + 1)]) for i in range(5)], 8
    )
    store.write("SMALL_DATA", csr, ids=[f"v{i}" for i in range(5)])
    assert store.tables() == ["SMALL_DATA"]
    full, ids = store.read("SMALL_DATA")
    assert full.n_rows == 5 and ids[3] == "v3"
    # inclusive row range (LoadData semantics)
    part, pids = store.load_range("SMALL_DATA", 1, 3)
    assert part.n_rows == 3 and pids == ["v1", "v2", "v3"]
    np.testing.assert_array_equal(part.row(0).indices, [1])
    # max-weight side table
    mw = store.max_weights("SMALL_DATA")
    assert mw[4] == 5.0
    # empty range
    empty, eids = store.load_range("SMALL_DATA", 4, 2)
    assert empty.n_rows == 0 and eids == []


def test_split_load_range():
    # parseLoadDataRequest parity: inclusive sub-ranges covering [0, 9]
    ranges = split_load_range(0, 9, 3)
    assert ranges[0] == (0, 2)
    assert ranges[-1][1] == 9
    covered = [x for s, e in ranges for x in range(s, e + 1)]
    assert covered == list(range(10))
    # more ranges than rows: falls back to single-row ranges
    assert split_load_range(0, 1, 5) == [(0, 0), (1, 1)]


def test_ccweb_parser():
    vid, vec = parse_ccweb_line("(773,4,[0.0,1.5,0.0,2.5])")
    assert vid == "773"
    assert vec.size == 4
    np.testing.assert_array_equal(vec.indices, [1, 3])
    np.testing.assert_allclose(vec.values, [1.5, 2.5])


def test_run_mode_debug_text_tables(tmp_path):
    # DEBUG run_mode (the reference's human-readable cell encoding,
    # WriteWorkerActor.scala:83-130): write emits a text mirror, and a
    # hand-written text-only table is readable
    import numpy as np

    from apsim.etl.store import VectorStore
    from apsim.vector.batch import CSRMatrix
    from apsim.vector.sparse import Vectors

    vecs = [Vectors.sparse(10, [1, 3], [0.6, 0.8]),
            Vectors.sparse(10, [2], [1.0])]
    csr = CSRMatrix.from_vectors(vecs, 10)
    st = VectorStore(str(tmp_path / "dbg"), run_mode="DEBUG")
    st.write("t", csr)
    assert (tmp_path / "dbg" / "t" / "vectors.txt").exists()
    # PRODUCT: binary only
    st2 = VectorStore(str(tmp_path / "prod"), run_mode="PRODUCT")
    st2.write("t", csr)
    assert not (tmp_path / "prod" / "t" / "vectors.txt").exists()
    # hand-written text-only table
    import os

    d = tmp_path / "dbg" / "hand"
    os.makedirs(d)
    (d / "vectors.txt").write_text("(10,[1,3],[0.6,0.8])\n(10,[2],[1.0])\n")
    got, ids = st.read("hand")
    assert got.n_rows == 2 and ids == ["0", "1"]
    sub, sids = st.load_range("hand", 1, 1)
    assert sub.n_rows == 1 and sids == ["1"]
