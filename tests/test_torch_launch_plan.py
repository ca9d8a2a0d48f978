"""How each emitted kernel lies on the H100 (``codegen_cuda.LaunchPlan``),
checked on the CPU.

* At the full smollm-135m width and the serving shapes (decode batch 4,
  prompt buckets 8/16/32, max_len 96) the SwiGLU group g0 lifts ``K``
  back onto its launch grid, ``(M, K)`` = 12 cells, and splits its ``D``
  reduction over a cluster of 6: 72 blocks; the down projection g1 keeps
  its grid ``(M, N)`` = 6 cells and splits ``K`` over a cluster of 12: 72
  blocks.  Attention (coupled online-softmax carries) is never split.
* The lifting rule refuses a dim that a member reduces over, loops over
  serially, or consumes as a list another member produced; the cluster
  size is the divisor of the trip count that brings the blocks closest to
  the 132 SMs.
* A plain torch runner that follows the plan (every launch cell on its
  own; members that do not touch a lifted dim recomputed in every cell,
  their outputs taken from cell 0; the split reduction run by each rank
  over its share of the trips, the ranks' partials combined in rank
  order) equals each kernel's plain version within 1e-6, for every fusion
  snapshot of the five in-repo programs and the full-width SwiGLU at the
  decode shape, and, chained over a program, the reference's Pallas
  kernels in interpret mode within 2e-4 (the coverage tests' tolerance).
"""

import itertools

import numpy as np
import pytest
import torch

from repro import pipeline as JP
from repro.core import array_program as JAP
from repro.core import codegen_pallas as JCP
from repro.core.fusion import fuse as j_fuse
from repro_torch.core import array_program as TAP
from repro_torch.core import codegen_cuda as CC
from repro_torch.core import codegen_torch as CT
from repro_torch.core import numerics as NU
from repro_torch.core import ops as O
from repro_torch.core import regions as R
from repro_torch.core.fusion import fuse
from repro_torch.core.graph import (FuncNode, InputNode, MapNode,
                                    OutputNode, ReduceNode)
from repro_torch.launch import serve as S
from repro_torch.pipeline import packing as P
from test_torch_cuda import (PROGRAMS, SERVING,  # noqa: E402
                             TENSOR_SHAPE, merged_inputs,
                             serving_programs)
import torch_port  # noqa: F401


# -- the plans at the serving shapes -----------------------------------------

@pytest.mark.parametrize("name", SERVING)
def test_launch_plan_at_the_serving_shapes(name):
    kernels = serving_programs()[name].kernels
    plans = [k.plan for k in kernels]
    if name.startswith("attention"):
        assert plans == [CC.LaunchPlan(("H", "M", "L"), (), 3)]
        assert kernels[0].blocks == 3 and kernels[0].plan.cluster_size == 1
        return
    g0, g1 = plans
    assert (g0.grid, g0.lifted, g0.launch_dims) == (("M",), ("K",),
                                                    ("M", "K"))
    assert (g0.cells, g0.cluster_dim, g0.cluster_size, g0.blocks) == (
        12, "D", 6, 72)
    assert (g1.grid, g1.lifted, g1.launch_dims) == (("M", "N"), (),
                                                    ("M", "N"))
    assert (g1.cells, g1.cluster_dim, g1.cluster_size, g1.blocks) == (
        6, "K", 12, 72)
    assert [k.blocks for k in kernels] == [72, 72]
    for k in kernels:
        assert f"{k.plan.blocks} blocks x instances" in k.source
        assert "cudaLaunchKernelEx" in k.source
        assert "cudaFuncAttributeNonPortableClusterSizeAllowed" in k.source \
            or k.plan.cluster_size <= CC.PORTABLE_CLUSTER


@pytest.mark.parametrize("trips,cells,want", [
    (6, 12, 6),     # g0: 12 cells x 6 = 72 blocks
    (12, 6, 12),    # g1: 6 cells x 12 = 72 blocks (non-portable size)
    (17, 4, 1),     # a prime past the largest cluster: no useful divisor
    (13, 4, 13),
    (8, 132, 1),    # the cells fill the card already
    (32, 6, 16),    # at most 16 ranks
    (1, 1, 1),
])
def test_cluster_size_is_the_divisor_nearest_the_sms(trips, cells, want):
    assert CC.cluster_size(trips, cells) == want


@pytest.mark.parametrize("trips,cells,resident,want", [
    (28, 148, 2, 7),    # qwen2-7b g1 at 32 rows: 1036 blocks, 4 waves
    (148, 28, 2, 8),    # its g2: 224 blocks in one wave (9 ranks: two)
    (28, 148, 1, 4),    # g1 at 64 rows, one block an SM: 592 blocks
    (28, 592, 1, 2),    # 256 rows: 1184 blocks
    (6, 12, 2, 6),      # smollm-135m g0: the trips bound the cluster
    (12, 6, 2, 12),     # its down projection: 6 clusters fit a wave
    (13, 22, 2, 7),     # ranks of 1 or 2 trips
    (8, 264, 2, 1),     # the cells fill a wave already
    (1, 1, 2, 1),
])
def test_fill_cluster_takes_the_least_modelled_time(trips, cells, resident,
                                                    want):
    cs = CC.fill_cluster(trips, cells, resident)
    assert cs == want
    best = CC.sum_time(trips, cells, cs, resident)
    assert all(CC.sum_time(trips, cells, c, resident) >= best
               for c in range(1, min(trips, CC.MAX_CLUSTER) + 1))


def test_wave_clusters_pack_portable_sizes_and_gpcs_past_them():
    """Up to 8 ranks a wave holds the card's 132 x resident slots in whole
    clusters; past 8, whole clusters in each of 8 GPCs of 16 SMs."""
    assert CC.wave_clusters(1, 2) == 264
    assert CC.wave_clusters(8, 2) == 33 and CC.wave_clusters(7, 1) == 18
    assert CC.wave_clusters(9, 2) == 8 * 3
    assert CC.wave_clusters(16, 1) == 8


@pytest.mark.parametrize("smem,blocks", [
    (16640, 2), (92160, 2), (115712, 2), (115713, 1), (131072, 1),
    (CC.SMEM_LIMIT, 1)])
def test_resident_blocks_by_shared_memory(smem, blocks):
    """Two blocks a tensor-core kernel an SM (its ``__launch_bounds__``
    minimum) while their shared memory and the runtime's 1 KB each fit
    the SM's 228 KB, else one."""
    assert CC.resident_blocks(smem) == blocks


def _qwen2_7b_swiglu(t):
    """The emitted SwiGLU kernels (g0, g1, g2) at qwen2-7b's widths over
    ``t`` token rows, as the model layers compile them."""
    from repro_torch import configs as C
    from repro_torch.models import layers as L
    cfg = C.get_config("qwen2-7b")
    return L.swiglu_kernel(t, cfg.d_model, cfg.d_ff, float(cfg.norm_eps),
                           L._pipeline_options("cuda"), "cuda").kernels


@pytest.mark.parametrize("t,rows,blocks,clusters", [
    (32, 32, [14, 1036, 224], [14, 7, 8]),     # decode and prefill 32
    (64, 64, [14, 592, 224], [14, 4, 8]),      # prefill 64
    (256, 64, [56, 1184, 224], [14, 2, 2]),    # prefill 256: 4 row blocks
])
def test_tensor_core_plans_fill_the_card(t, rows, blocks, clusters):
    """At qwen2-7b's widths from 16 rows on, g1 and g2 take the tensor
    cores and their clusters come from :func:`fill_cluster` at the blocks
    an SM holds of each (its shared memory, ``MIN_BLOCKS`` at most): the
    launch's last wave keeps 84 % of the card's slots or more (224 of
    264).  g0 (no product) keeps the parent's plan."""
    g0, g1, g2 = _qwen2_7b_swiglu(t)
    assert [k.blocks for k in (g0, g1, g2)] == blocks
    assert [k.plan.cluster_size for k in (g0, g1, g2)] == clusters
    assert g0.product_path == CC.FMA_PATH
    for k in (g1, g2):
        assert k.product_path == CC.TENSOR_PATH
        assert f"tiles::dot_k_sum<{rows}, 128, 128, " in k.source
        assert k.smem_bytes <= CC.SMEM_LIMIT
        resident = CC.resident_blocks(k.smem_bytes)
        trips = 28 if k is g1 else 148
        assert k.plan.cluster_size == CC.fill_cluster(trips, k.plan.cells,
                                                      resident)
        slots = CC.SMS * resident
        assert k.blocks / (-(-k.blocks // slots) * slots) >= 0.84, k.gid
        assert f"__launch_bounds__(256, {resident})" in k.source


@pytest.mark.parametrize("t", [4, 8])
def test_fma_plans_are_kept_below_16_rows(t):
    """At 4 and 8 rows (decode at chip_smoke's batch, the 8-token
    prefill) every qwen2-7b SwiGLU kernel keeps ``tiles::dot_k`` on the
    CUDA cores and the cluster rule of :func:`cluster_size`: g0 one
    14-rank cluster over D, g1 148 blocks with no cluster, g2 28 cells x
    a 4-rank K cluster."""
    kernels = _qwen2_7b_swiglu(t)
    assert [(k.plan.cells, k.plan.cluster_dim, k.plan.cluster_size)
            for k in kernels] == [(1, "D", 14), (148, None, 1),
                                  (28, "K", 4)]
    for k in kernels:
        assert k.product_path == CC.FMA_PATH
        assert "tiles::dot_k_sum<" not in k.source
        assert "__launch_bounds__(256) " in k.source


# -- the lifting rule ---------------------------------------------------------

def _groups(name, snapshot):
    build, dims, blocks = PROGRAMS[name]
    pp = R.plan_program(fuse(build(TAP))[snapshot])
    return R.group_plan(pp, dims, blocks).groups, pp.graph.infer_types()


def test_lifting_refuses_a_consumed_list_and_a_serial_loop():
    """rmsnorm_swiglu's first snapshot is one group over ``M``: the down
    projection (member 2) loops serially over ``K`` and consumes the list
    over ``K`` that the gate/up member produced, so ``K`` stays in the
    block; ``N`` (member 2's spine only) is lifted."""
    (group,), types = _groups("rmsnorm_swiglu", 0)
    assert group.grid_dims == ("M",)
    assert CC.lift_refusals(group.members, "K", types) == [
        "member 2 consumes the list over K that member 1 produced",
        "member 2 loops serially over K"]
    assert CC.lift_refusals(group.members, "N", types) == []
    assert "member 1 loops serially over D" in CC.lift_refusals(
        group.members, "D", types)


def _reduce_program():
    """An elementwise (M, K) member feeding a row reduction over K: the
    group's grid shrinks to (M), the reducing member holds a ReduceNode."""
    ap = TAP.ArrayProgramBuilder()
    x = ap.input("X", ("M", "K"))
    ap.output("S", ap.reduce_rows(ap.elementwise("a0 * a0 + 1.0", x),
                                  "sqrt(a0)"))
    return ap.build()


def test_lifting_refuses_a_reduced_dim():
    g = _reduce_program()
    dims, blocks = {"M": 2, "K": 4}, {"M": 4, "K": 8}
    pp = R.plan_program(g)
    (group,) = R.group_plan(pp, dims, blocks).groups
    assert group.grid_dims == ("M",)
    assert any(isinstance(n, ReduceNode)
               for n in group.members[1].graph.nodes[1].inner.nodes.values())
    assert CC.lift_refusals(group.members, "K", pp.graph.infer_types()) == [
        "member 1 consumes the list over K that member 0 produced",
        "member 1 reduces over K"]
    (kern,) = [k for _, k in CC.emit_program(g, dims, blocks)[0]
               .region_runners]
    # nothing lifted; the reduce is split over a cluster of its 4 trips
    assert kern.plan == CC.LaunchPlan(("M",), (), 2, "K", 4, (1, (1, 1)))


def test_coupled_carries_and_mixed_accumulators_are_not_split():
    """Attention's fused region carries a running max and ``+@k``
    rescaled sums; layernorm_matmul's fused region accumulates items of
    two shapes.  Neither gets a cluster."""
    for name in ("flash", "causal", "gqa", "layernorm_matmul"):
        build, dims, blocks = PROGRAMS[name]
        snap = fuse(build(TAP))[-1]
        if name != "layernorm_matmul":
            snap = NU.stabilize(snap)
        fn, _ = CC.emit_program(snap, dims, blocks)
        for _, k in fn.region_runners:
            assert k.plan.split is None and k.plan.cluster_size == 1, name


# -- a plain runner that follows the plan -------------------------------------

def _eval(g, inputs, dims, nb, pins, split):
    """``codegen_torch._eval`` under a launch plan: maps over the pinned
    (lifted) dims evaluate the one index of this launch cell (keeping a
    size-1 axis), and ``split = (path, ranks)`` names the node, reached
    through maps over launch dims, whose reduction each rank runs over its
    share of the trips before the partials are combined in rank order."""
    types = g.infer_types()
    env = {(nid, 0): v for nid, v in zip(g.input_ids, inputs)}
    outs = {}
    for nid in g.topo():
        node = g.nodes[nid]
        if isinstance(node, InputNode):
            continue
        edges = g.in_edges(nid)
        ins = [env[(e.src, e.sp)] for e in edges]
        here = split is not None and split[0] == (nid,)
        below = (split[0][1:], split[1]) if (
            split is not None and len(split[0]) > 1
            and split[0][0] == nid) else None
        if isinstance(node, OutputNode):
            outs[nid] = ins[0]
        elif isinstance(node, FuncNode):
            kinds = [types[(e.src, e.sp)].item for e in edges]
            env[(nid, 0)] = CT.apply_op(node.op, ins, kinds, nb)
        elif isinstance(node, ReduceNode):
            if not here:
                env[(nid, 0)] = CT._reduce(node, ins[0], nb)
                continue
            per = ins[0].shape[nb] // split[1]
            parts = [ins[0].float().narrow(nb, r * per, per)
                     for r in range(split[1])]
            env[(nid, 0)] = _combine(
                [[p.amax(nb) if node.op == O.REDUCE_MAX else p.sum(nb)]
                 for p in parts], [node.op])[0]
        elif isinstance(node, MapNode):
            if here:
                res = _serial_ranks(node, ins, dims, nb, split[1])
            elif node.serial:
                res = CT._lower_map(node, ins, dims, nb)
            else:
                res = _parallel(node, ins, dims, nb, pins, below)
            for p, r in enumerate(res):
                env[(nid, p)] = r
    return [outs[oid] for oid in g.output_ids]


def _parallel(node, ins, dims, nb, pins, split):
    d = node.dim
    if d in pins:
        inner = [v.narrow(nb, pins[d], 1) if m else v.unsqueeze(nb)
                 for v, m in zip(ins, node.mapped)]
        return _eval(node.inner, inner, dims, nb + 1, pins, split)
    inner = [v if m else v.unsqueeze(nb) for v, m in zip(ins, node.mapped)]
    res = _eval(node.inner, inner, dims, nb + 1, pins, split)
    return [r.expand(*r.shape[:nb], dims[d], *r.shape[nb + 1:])
            for r in res]


def _combine(partials, tags):
    """Per port, the ranks' partials summed (or maxed), rank 0 first."""
    out = list(partials[0])
    for part in partials[1:]:
        out = [torch.maximum(a, b) if t == O.REDUCE_MAX else a + b
               for a, b, t in zip(out, part, tags)]
    return out


def _serial_ranks(node, ins, dims, nb, ranks):
    trips = dims[node.dim]
    partials = []
    for r in range(ranks):
        carry = None
        for i in range(r * trips // ranks, (r + 1) * trips // ranks):
            body = [v.select(nb, i) if m else v
                    for v, m in zip(ins, node.mapped)]
            vals = [x.float() for x in CT._eval(node.inner, body, dims, nb)]
            carry = vals if carry is None else _combine([carry, vals],
                                                        node.reduced)
        partials.append(carry)
    return _combine(partials, node.reduced)


def plan_runner(kern, members, in_refs, out_refs, types, dims):
    """Merged inputs in, merged outputs out, cell by cell as ``kern``'s
    launch plan lays the kernel on the card."""
    plan = kern.plan

    def run(*merged):
        stacked = {r: P.to_stacked(a, types[r], dims, 0)
                   for r, a in zip(in_refs, merged)}
        full = {}
        for cell in itertools.product(*[range(dims[d])
                                         for d in plan.lifted]):
            pins = dict(zip(plan.lifted, cell))
            env = dict(stacked)
            for mi, spec in enumerate(members):
                split = ((plan.split[1], plan.cluster_size)
                         if plan.split and plan.split[0] == mi else None)
                res = _eval(spec.graph, [env[r] for r in spec.in_refs],
                            dims, 0, pins, split)
                env.update(zip(spec.out_refs, res))
                if any(pins[d] for d in plan.lifted
                       if d not in spec.grid_dims):
                    continue        # only the cells at index 0 write
                for r, v in zip(spec.out_refs, res):
                    if r not in out_refs:
                        continue
                    vdims = types[r].dims
                    if r not in full:
                        shape = list(v.shape)
                        for d in pins:
                            if d in vdims:
                                shape[vdims.index(d)] = dims[d]
                        full[r] = torch.empty(shape, dtype=v.dtype)
                    index = [slice(None)] * v.dim()
                    for d, i in pins.items():
                        if d in vdims:
                            index[vdims.index(d)] = slice(i, i + 1)
                    full[r][tuple(index)] = v
        return tuple(P.from_stacked(full[r], types[r], dims, 0)
                     for r in out_refs)

    return run


def _kernels_with_members(snap, dims, blocks, group):
    """The emitted program of ``snap``, its kernels with the members each
    runs, the partitioned program's types and its output refs."""
    pp = R.plan_program(snap)
    gp = R.group_plan(pp, dims, blocks) if group else R.ungrouped_plan(pp)
    fn, _ = CC.emit_program(snap, dims, blocks, program_plan=pp,
                            grouped_plan=gp)
    kernels = []
    for grp, (kr, kern) in zip(gp.groups, fn.region_runners):
        assert grp.gid == kr.gid
        kernels.append((kr, kern, grp.members))
    out_refs = [(e.src, e.sp) for o in pp.graph.output_ids
                for e in [pp.graph.in_edge(o, 0)]]
    return fn, kernels, pp.graph.infer_types(), out_refs


def _run_by_plan(fn, kernels, types, dims, feed):
    """Every kernel's plan runner, chained; each held against the
    kernel's plain version on the same inputs."""
    env = dict(zip(fn.input_refs, feed))
    for kr, kern, members in kernels:
        kin = [env[r] for r in kr.in_refs]
        got = plan_runner(kern, members, kr.in_refs, kr.out_refs, types,
                          dims)(*kin)
        for g_, w_ in zip(got, kern.plain(*kin)):
            torch.testing.assert_close(g_, w_, rtol=1e-6, atol=1e-6,
                                       msg=kern.gid)
        env.update(zip(kr.out_refs, got))
    return env


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_plan_runner_matches_plain_and_reference(name):
    """Every snapshot, grouped and one kernel per region; against the
    reference's interpret mode for the grouped lowering."""
    build, dims, blocks = PROGRAMS[name]
    g, jg = build(TAP), build(JAP)
    inputs = merged_inputs(g, dims, blocks)
    planned = 0
    for i, (snap, jsnap) in enumerate(zip(fuse(g), j_fuse(jg))):
        feed = [torch.from_numpy(inputs[snap.nodes[j].name])
                for j in snap.input_ids]
        for group in (True, False):
            fn, kernels, types, out_refs = _kernels_with_members(
                snap, dims, blocks, group)
            planned += sum(bool(k.plan.lifted or k.plan.split)
                           for _, k, _ in kernels)
            env = _run_by_plan(fn, kernels, types, dims, feed)
            if not group:
                continue
            jfn, _ = JCP.emit_program(jsnap, dims, blocks, interpret=True)
            want = jfn(*[inputs[jsnap.nodes[j].name]
                         for j in jsnap.input_ids])
            for r, w in zip(out_refs, want):
                np.testing.assert_allclose(env[r].numpy(), np.asarray(w),
                                           rtol=2e-4, atol=2e-4,
                                           err_msg=f"{name}[{i}]")
    assert planned > 0, f"{name}: no kernel lifts a dim or splits"


def test_plan_runner_at_full_width_swiglu_decode():
    """The serving decode shape (4 tokens, d_model 576, d_ff 1536): g0's
    12 lifted K cells and 6-rank D split, g1's 12-rank K split, against
    the plain versions and the reference's interpret mode."""
    ck = serving_programs()["swiglu_decode"]
    dims, blocks = ck.dims, ck.blocks
    fn, kernels, types, out_refs = _kernels_with_members(ck.graph, dims,
                                                         blocks, True)
    assert [k.blocks for _, k, _ in kernels] == [72, 72]
    rng = np.random.default_rng(0)
    d, dff = 576, 1536
    inputs = {"X": rng.normal(size=(4, d)),
              "WT": rng.normal(size=(dff, d)) * d ** -0.5,
              "VT": rng.normal(size=(dff, d)) * d ** -0.5,
              "UT": rng.normal(size=(d, dff)) * dff ** -0.5}
    inputs = {k: v.astype(np.float32) for k, v in inputs.items()}
    names = [ck.graph.nodes[j].name for j in ck.graph.input_ids]
    env = _run_by_plan(fn, kernels, types, dims,
                       [torch.from_numpy(inputs[n]) for n in names])
    eps = float(S.model_config(S.ServeConfig()).norm_eps)
    ref = JP.compile(JAP.rmsnorm_ffn_swiglu_program(float(d), eps=eps),
                     dims, options=JP.CompileOptions(backend="pallas",
                                                     blocks=blocks))
    want = ref({n: inputs[n] for n in names})[ref.out_names[0]]
    np.testing.assert_allclose(env[out_refs[0]].numpy(), np.asarray(want),
                               rtol=2e-4, atol=2e-4)


def test_plan_runner_on_the_tensor_core_path():
    """The compiled program is one kernel whose products all run in
    ``tiles::dot_k_sum`` (the gate/up in a loop over K, the down
    projection's operand a in shared memory), its K reduction split over 7
    ranks of 1 or 2 trips: the plan runner against the plain version and
    the reference's interpret mode."""
    from repro_torch import pipeline as TP
    dims, blocks = TENSOR_SHAPE
    g = TAP.rmsnorm_ffn_swiglu_program(16.0)
    ck = TP.compile(g, dims, options=TP.CompileOptions(backend="cuda",
                                                       blocks=blocks))
    fn, kernels, types, out_refs = _kernels_with_members(ck.graph, dims,
                                                         blocks, True)
    ((_, kern, _),) = kernels
    assert kern.product_path == CC.TENSOR_PATH
    assert "tiles::dot_k_sum<16, 8, 16, 1, 16, 4, false, true>" in (
        kern.source)
    assert (kern.plan.cluster_dim, kern.plan.cluster_size) == ("K", 7)
    inputs = merged_inputs(g, dims, blocks)
    names = [ck.graph.nodes[j].name for j in ck.graph.input_ids]
    env = _run_by_plan(fn, kernels, types, dims,
                       [torch.from_numpy(inputs[n]) for n in names])
    ref = JP.compile(JAP.rmsnorm_ffn_swiglu_program(16.0), dims,
                     options=JP.CompileOptions(backend="pallas",
                                               blocks=blocks))
    want = ref({n: inputs[n] for n in names})[ref.out_names[0]]
    np.testing.assert_allclose(env[out_refs[0]].numpy(), np.asarray(want),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("trips,cs", [(28, 7), (28, 4), (13, 7), (16, 5),
                                       (13, 1)])
def test_split_loop_ranks_cover_the_trips(trips, cs):
    """A split CUDA-core loop gives rank r the trips [r T / cs, (r + 1) T /
    cs), as ``tiles::dot_k_sum`` does, whether or not cs divides T: the
    ranks' ranges, evaluated from the emitted bounds, cover every trip
    once, and the per-block operation count times the ranks is the
    unsplit loop's.  Where cs divides T the loop's text is the old one."""
    import re
    em = CC._Emitter({"K": trips}, (), None, cs)
    em.loop("K", split=True)
    em.count_flops(3)
    m = re.fullmatch(r"\s*for \(int (\w+) = (.+); \1 < (.+); \+\+\1\) \{",
                     em.lines[-1])
    assert m, em.lines[-1]

    def at(expr, rank):       # C's integer arithmetic on non-negatives
        return eval(expr.replace("/", "//"), {"rank": rank})

    covered = [i for r in range(cs)
               for i in range(at(m[2], r), at(m[3], r))]
    assert covered == list(range(trips))
    assert em.flops * cs == pytest.approx(3 * trips)
    if trips % cs == 0:
        assert m[2] == f"rank * {trips // cs}"


# -- the launch path's first-call validation ----------------------------------

def test_a_signature_is_validated_once_in_full():
    """``CudaKernel._signature`` (run on the first call of each signature;
    CPU tensors suffice, it touches no card): the output shapes, instance
    extents and stride array, and the refusal of an input that
    ``tiles::dot_k`` stages by 16-byte copies at an instance stride that
    is not a multiple of 4 elements."""
    kern = serving_programs()["attention_decode"].kernels[0]
    assert kern.aligned == (0, 1, 2)          # Q, K^T, V^T are staged
    ins = [torch.zeros((4, 3) + s) for s in kern.in_full]
    _, outs, strides, e0, e1 = kern._signature(ins, 2)
    assert outs == [(4, 3) + kern.out_full[0]] and (e0, e1) == (4, 3)
    q = ins[0]
    assert list(strides)[:2] == [q.stride(0), q.stride(1)]
    n = q[0, 0].numel() + 2                   # 194: not a multiple of 4
    ins[0] = torch.zeros(4 * 3 * n).as_strided(q.shape,
                                               (3 * n, n) + q.stride()[2:])
    with pytest.raises(ValueError, match="multiples of 4"):
        kern._signature(ins, 2)
    ins[0] = torch.zeros((4, 3, 2) + kern.in_full[0][1:])
    with pytest.raises(ValueError, match="has shape"):
        kern._signature(ins, 2)
