"""The chordal decomposition of cosmo_tpu_torch (chordal/, native/) against
cosmo_tpu.chordal on the same problems: the same cliques, the same
decomposed problem (sets, A, b, P, q, row maps, overlap rows) and the same
reverse, with the native C++ helpers and without them."""
import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp

import cosmo_tpu as ct
import cosmo_tpu_torch as pt
from cosmo_tpu import chordal as jch
from cosmo_tpu import native as jnative
from cosmo_tpu import problems as jprob
from cosmo_tpu.chordal import graph as jgraph
from cosmo_tpu.chordal import trees as jtrees
from cosmo_tpu_torch import chordal as tch
from cosmo_tpu_torch import convert
from cosmo_tpu_torch import native as tnative
from cosmo_tpu_torch import problems as tprob
from cosmo_tpu_torch.chordal import graph as tgraph
from cosmo_tpu_torch.chordal import trees as ttrees

# the docs example's sparsity graph (reference docs/src/decomposition.md,
# tests/test_chordal.py), 0-based edges
DOCS_EDGES = [(0, 2), (0, 5), (1, 2), (2, 5), (2, 6), (2, 7), (3, 4), (3, 7),
              (4, 7), (5, 6), (5, 7), (6, 7), (5, 8), (6, 8), (7, 8)]


def _docs_example(prob, sparse=False):
    """The dual-form SDP whose aggregate sparsity is the docs example's
    9x9 graph (a weighted Laplacian on those edges)."""
    W = np.zeros((9, 9))
    for e, (i, j) in enumerate(DOCS_EDGES):
        W[i, j] = W[j, i] = 0.5 + 0.1 * e
    return prob._dual_form_sdp(np.diag(W.sum(1)) - W, np.float64, sparse=sparse)


PROBLEMS = {
    "banded60": lambda prob: prob.banded_sdp(60, 4)[:5],
    "banded200_sparse": lambda prob: prob.banded_sdp(200, 8, sparse=True)[:5],
    "maxcut40": lambda prob: prob.maxcut(40, 0.15)[:5],
    "docs9x9": _docs_example,
}


@pytest.fixture(params=["native", "python"])
def native_mode(request, monkeypatch):
    """Both packages with their native library, or both on the pure-Python
    path (the library reported missing)."""
    if request.param == "native":
        if not (jnative.available() and tnative.available()):
            pytest.skip("g++ cannot build the native library here")
    else:
        monkeypatch.setattr(jnative, "_load", lambda: None)
        monkeypatch.setattr(tnative, "_load", lambda: None)
    return request.param


def _cone_key(s):
    return type(s).__name__, s.dim


def _same_matrix(a, b):
    if sp.issparse(a) or sp.issparse(b):
        assert sp.issparse(a) and sp.issparse(b)
        assert a.shape == b.shape
        a, b = sp.csr_matrix(a), sp.csr_matrix(b)
        assert np.array_equal(a.indptr, b.indptr)
        assert np.array_equal(a.indices, b.indices)
        a, b = a.data, b.data
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert np.abs(a - b).max(initial=0.0) <= 1e-15 * max(1.0, np.abs(a).max(initial=0.0))


def _decompose_both(name):
    settings = dict(decompose=True, accelerator=None)
    jinfo = jch.decompose(*PROBLEMS[name](jprob), ct.Settings(**settings))
    tinfo = tch.decompose(*PROBLEMS[name](tprob), pt.Settings(**settings))
    return jinfo, tinfo


@pytest.mark.parametrize("name", list(PROBLEMS))
def test_decompose_matches_reference(name, native_mode):
    jinfo, tinfo = _decompose_both(name)
    assert jinfo is not None and tinfo is not None
    for a, b in zip(jinfo.problem[:4], tinfo.problem[:4]):
        _same_matrix(a, b)
    assert [_cone_key(s) for s in jinfo.problem[4]] == [_cone_key(s) for s in tinfo.problem[4]]
    assert [_cone_key(s) for s in jinfo.sets_orig] == [_cone_key(s) for s in tinfo.sets_orig]
    assert (jinfo.m_orig, jinfo.n_orig, jinfo.mode, jinfo.num_overlaps) == (
        tinfo.m_orig, tinfo.n_orig, tinfo.mode, tinfo.num_overlaps)
    assert tinfo.num_overlaps > 0
    for f in ("row_map", "ov_child_rows", "ov_parent_rows"):
        assert np.array_equal(getattr(jinfo, f), getattr(tinfo, f)), f
    _same_matrix(jinfo.S, tinfo.S)
    assert len(jinfo.patterns) == len(tinfo.patterns)
    for jp, tp in zip(jinfo.patterns, tinfo.patterns):
        assert np.array_equal(jp.ordering, tp.ordering)
        assert (jp.cone_index, jp.row_start, jp.side) == (tp.cone_index, tp.row_start, tp.side)
        assert jp.tree.snd == tp.tree.snd and jp.tree.sep == tp.tree.sep
        assert np.array_equal(jp.tree.snd_post, tp.tree.snd_post)


def _info_as_dict(info):
    """A cosmo_tpu ChordalInfo as the dict convert.chordal_info_from_dict
    takes: dataclass fields, each cone with its class name as "type"."""
    def fields(obj):
        return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}

    def cone(s):
        return dict(fields(s), type=type(s).__name__)

    P, q, A, b, sets = info.problem
    return dict(fields(info), problem=(P, q, A, b, [cone(s) for s in sets]),
                sets_orig=[cone(s) for s in info.sets_orig],
                patterns=[dict(fields(p), tree=dict(fields(p.tree),
                                                    merge_log=fields(p.tree.merge_log)))
                          for p in info.patterns])


@pytest.mark.parametrize("carried", [False, True], ids=["port", "carried"])
@pytest.mark.parametrize("complete_dual", [False, True])
@pytest.mark.parametrize("name", ["banded200_sparse", "maxcut40"])
def test_reverse_matches_reference(name, complete_dual, carried):
    """reverse of the same decomposed-space (x, y, s) gives the same
    original-space vectors; with complete_dual the PSD completion of the
    dual too. ``carried``: the port reverses through the reference's own
    decomposition, carried across by convert.chordal_info_from_dict."""
    jinfo, tinfo = _decompose_both(name)
    if carried:
        tinfo = convert.chordal_info_from_dict(_info_as_dict(jinfo))
        assert isinstance(tinfo, tch.ChordalInfo)
    m, n = jinfo.problem[2].shape
    rng = np.random.default_rng(7)
    x, y, s = rng.standard_normal(n), rng.standard_normal(m), rng.standard_normal(m)
    jout = jch.reverse(jinfo, x, y, s, ct.Settings(complete_dual=complete_dual))
    tout = tch.reverse(tinfo, x, y, s, pt.Settings(complete_dual=complete_dual))
    for a, b in zip(jout, tout):
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= 1e-12 * max(1.0, np.abs(a).max())


def test_docs_example_cliques_match_reference():
    """The 9x9 docs graph gives the same chordal extension and clique tree
    in both packages (reference cliques {1,3,6}, {2,3}, {3,6,7,8},
    {4,5,8}, {6,7,8,9}, 1-based)."""
    adj = [set() for _ in range(9)]
    for i, j in DOCS_EDGES:
        adj[i].add(j)
        adj[j].add(i)
    jcols, jperm = jgraph.chordal_extension(adj)
    tcols, tperm = tgraph.chordal_extension(adj)
    assert np.array_equal(jperm, tperm)
    assert all(np.array_equal(a, b) for a, b in zip(jcols, tcols))
    jt = jtrees.build_clique_tree(jcols, graph_mode=False)
    tt = ttrees.build_clique_tree(tcols, graph_mode=False)
    assert tt.num == jt.num == 5
    assert tt.snd == jt.snd and tt.sep == jt.sep
    cliques = {frozenset(int(tperm[v]) + 1 for v in (tt.snd[c] | tt.sep[c]))
               for c in map(int, tt.snd_post[: tt.num])}
    assert cliques == {frozenset({1, 3, 6}), frozenset({2, 3}), frozenset({3, 6, 7, 8}),
                       frozenset({4, 5, 8}), frozenset({6, 7, 8, 9})}


def test_dense_pattern_is_not_decomposed():
    P, q, A, b, sets, _ = tprob.closest_correlation(6)
    assert tch.decompose(P, q, A, b, sets, pt.Settings()) is None


def test_colpad_layout_raises():
    """A clique block of padded side >= colpad_min takes the column-padded
    layout; it raised until the fifth slice ported it. Now the
    decomposition no longer raises and gives the reference's cone list,
    matrices and row maps, with every block column-padded."""
    settings = dict(decompose=True, colpad_min=8)
    jinfo = jch.decompose(*PROBLEMS["banded60"](jprob), ct.Settings(**settings))
    tinfo = tch.decompose(*PROBLEMS["banded60"](tprob), pt.Settings(**settings))
    assert [_cone_key(s) for s in jinfo.problem[4]] == [_cone_key(s) for s in tinfo.problem[4]]
    assert {type(s).__name__ for s in tinfo.problem[4]} == {"PsdConeTriangleColPad"}
    for a, b in zip(jinfo.problem[:4], tinfo.problem[:4]):
        _same_matrix(a, b)
    for f in ("row_map", "ov_child_rows", "ov_parent_rows"):
        assert np.array_equal(getattr(jinfo, f), getattr(tinfo, f)), f


def test_generators_identical():
    for name, gen in PROBLEMS.items():
        for a, b in zip(gen(jprob)[:4], gen(tprob)[:4]):
            _same_matrix(a, b)
    for a, b in zip(jprob.closest_correlation(7, seed=3), tprob.closest_correlation(7, seed=3)):
        if isinstance(a, list):
            assert [_cone_key(s) for s in a] == [_cone_key(s) for s in b]
        else:
            assert np.array_equal(a, b)
    L1, L2 = jprob.maxcut(30, 0.2, sparse=True)[5], tprob.maxcut(30, 0.2, sparse=True)[5]
    _same_matrix(L1, L2)
