"""Property test (port of ``tests/test_analysis_properties.py``): for
random expression graphs, the port's lowering and planner always satisfy
the static verifier's independently derived proofs — pad-state
discipline holds, the derived plan's launch budget covers the computed
Chebyshev reach, and every CUDA launch the executable makes is
feasible, reads in bounds and partitions its output (the launch model
of ``repro_torch.analysis.indexmaps``, in place of the reference's
BlockSpec enumeration).  The reference's proofs hold on the same graph.

Gated on Hypothesis, as the reference's is.
"""
import pytest

hypothesis = pytest.importorskip("hypothesis",
                                 reason="hypothesis not installed")
from hypothesis import HealthCheck, given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

import repro.api as RAPI  # noqa: E402
from repro import analysis as RA  # noqa: E402
from repro_torch import analysis as A  # noqa: E402
from repro_torch.analysis import indexmaps as IM  # noqa: E402
from repro_torch.analysis.halo import segment_reach  # noqa: E402
from repro_torch.api import E  # noqa: E402
from repro_torch.api.compile import compile as compile_expr  # noqa: E402

pytestmark = pytest.mark.pipeline

_leaves = st.sampled_from(["f", "g"])


def _extend(children):
    chains = st.tuples(st.sampled_from(["erode", "dilate"]),
                       st.integers(1, 9), children)
    recons = st.tuples(st.sampled_from(["erode", "dilate"]),
                       children, children)
    return st.one_of(chains.map(lambda t: ("chain", *t)),
                     recons.map(lambda t: ("rec", *t)))


#: a graph as nested tuples, built on either package's ``E``
_graphs = st.recursive(_leaves, _extend, max_leaves=4)


def _build(api_e, g):
    if isinstance(g, str):
        return api_e.input(g)
    if g[0] == "chain":
        return getattr(api_e, g[1])(g[2], _build(api_e, g[3]))
    return api_e.reconstruct(_build(api_e, g[2]), _build(api_e, g[3]),
                             op=g[1])


@settings(max_examples=25, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(graph=_graphs, shape=st.sampled_from([(1, 40, 72), (2, 33, 70)]))
def test_lowering_satisfies_static_proofs(graph, shape):
    expr = _build(E, graph)
    if expr.kind == "input":
        return  # nothing lowered: no run phase to verify
    exe = compile_expr(expr, shape, "uint8", "cuda", verify=False,
                       device="cpu")

    assert A.check_program(exe.program) == [], expr

    if exe.plan is None:
        return
    plan, shape3 = exe.plan, shape

    assert [f for f in A.check_plan(plan, shape3)
            if f.severity == A.ERROR] == [], expr

    assert A.check_coverage(exe.program, plan, shape3) == [], expr
    reach = max((r for s in exe.program.segments
                 if (r := segment_reach(s)) is not None), default=0)
    if not exe.program.convergent:
        assert plan.n_chunks * plan.fuse_k >= reach, expr

    # every launch of the executable is feasible, in bounds, a partition
    assert IM.executable_launches(exe), expr
    assert IM.check_executable_launches(exe) == [], expr

    # the reference plans the same schedule and proves the same graph
    rexe = RAPI.compile(_build(RAPI.E, graph), shape, "uint8", "pallas",
                        verify=False)
    assert rexe.plan.key == plan.key, expr
    assert RA.check_program(rexe.program) == [], expr
