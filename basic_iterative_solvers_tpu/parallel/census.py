"""Structural communication-layout checks for the distributed solve paths.

A one-device environment can assert iteration/residual parity between the
single-device and mesh solves (test_gspmd.py, __graft_entry__.py), but
parity alone cannot see a *communication-layout* regression: a fused CG
whose SpMV all-gathers the full row-sharded vector every iteration computes
the same answer as one whose halos ride neighbor permutes — it just scales
like a broadcast instead of a stencil.  (The reference's MPI analog would
be calling MPI_Allgather per SpMV instead of point-to-point halo sends.)

This module lowers the GSPMD-partitioned fused while-loop program with its
REAL shardings (via the lifted runner's `.lower()`, solvers/fused.py),
compiles it, and counts the collectives XLA actually emitted — overall and
inside the while-loop body (the per-iteration cost).  XLA:GPU emits the
asynchronous forms (`all-reduce-start(` … `all-reduce-done(`); each
`-start` counts as one collective of its kind and `-done` is not counted.
The invariants the tests pin:

* the body carries scalar `all-reduce`s (the psum per dot product), and
* `collective-permute`s (the SpMV halo exchanges), and
* NO `all-gather`/`all-to-all` materializing a full-length vector —
  that is the signature of a scatter/pad GSPMD could not partition
  (exactly the bug fixed in ops/spmv.py `spmv_dia`: `zeros().at[].set(x)`
  made every SpMV all-gather x; `jnp.pad` partitions into halos).
"""
from __future__ import annotations

import re
from typing import Optional

COLLECTIVES = ("all-reduce", "all-gather", "collective-permute",
               "reduce-scatter", "all-to-all")

# `%name = f64[512]{0} all-gather(...)` / `%n = (f64[], f64[]) all-reduce(...)`
# and the async `%s = (f32[8]{0}, f32[32]{0}) all-gather-start(...)`
_OP_RE = re.compile(
    r"= (?P<shape>\((?:[^()]|\([^()]*\))*\)|[\w\[\],{}]+) "
    r"(?P<kind>all-reduce|all-gather|collective-permute|reduce-scatter|"
    r"all-to-all)(?:-start)?\(")
_SHAPE_RE = re.compile(r"[a-z]\d+\[([\d,]*)\]")
# computation header: `%name (params) -> result {` (ENTRY lines included)
_COMP_RE = re.compile(r"^(?:ENTRY )?%?([\w.\-]+) \(", re.M)
# references from one computation into another
_REF_RE = re.compile(
    r"(?:to_apply|body|condition|calls)=%?([\w.\-]+)"
    r"|branch_computations=\{([^}]*)\}")


def _result_elems(shape_txt: str) -> int:
    """Total element count across every array in an HLO result type."""
    total = 0
    for m in _SHAPE_RE.finditer(shape_txt):
        dims = m.group(1)
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n
    return total


def _computations(txt: str) -> dict:
    """Split optimized-HLO text into {computation_name: body_text}."""
    marks = [(m.start(), m.group(1)) for m in _COMP_RE.finditer(txt)]
    out = {}
    for i, (pos, name) in enumerate(marks):
        end = marks[i + 1][0] if i + 1 < len(marks) else len(txt)
        out[name] = txt[pos:end]
    return out


def _while_body_closure(comps: dict) -> set:
    """Names of while-loop body computations plus everything they reach."""
    roots = set()
    for body in comps.values():
        for m in re.finditer(r"while\(.*?\), condition=%?([\w.\-]+), "
                             r"body=%?([\w.\-]+)", body):
            roots.add(m.group(2))
    seen = set()
    stack = list(roots)
    while stack:
        name = stack.pop()
        if name in seen or name not in comps:
            continue
        seen.add(name)
        for m in _REF_RE.finditer(comps[name]):
            if m.group(1):
                stack.append(m.group(1))
            elif m.group(2):
                stack.extend(x.strip().lstrip("%")
                             for x in m.group(2).split(","))
    return seen


def hlo_collective_census(compiled_text: str,
                          full_vector_len: Optional[int] = None) -> dict:
    """Count collectives in optimized HLO text.

    Returns ``{kind: total}`` for every kind in COLLECTIVES plus

    * ``in_while`` — the same counts restricted to while-loop bodies
      (transitively: nested whiles, conds and called computations), i.e.
      the per-iteration communication;
    * ``full_gathers`` — ``(kind, where, elems)`` for every all-gather /
      all-to-all whose result holds ≥ ``full_vector_len`` elements
      ("where" is ``"while"`` or ``"setup"``) — empty when the layout is
      halo-clean.
    """
    comps = _computations(compiled_text)
    body_names = _while_body_closure(comps)
    totals = {k: 0 for k in COLLECTIVES}
    in_while = {k: 0 for k in COLLECTIVES}
    full_gathers = []
    for name, body in comps.items():
        inside = name in body_names
        for m in _OP_RE.finditer(body):
            kind = m.group("kind")
            totals[kind] += 1
            if inside:
                in_while[kind] += 1
            if (full_vector_len is not None
                    and kind in ("all-gather", "all-to-all")):
                elems = _result_elems(m.group("shape"))
                if elems >= full_vector_len:
                    full_gathers.append(
                        (kind, "while" if inside else "setup", elems))
    totals["in_while"] = in_while
    totals["full_gathers"] = full_gathers
    return totals


def fused_collective_census(setup, method=None) -> dict:
    """Lower + compile the fused while-loop program of `setup` (already
    shard_setup'd) with its real shardings and run the census on it.

    Runs one solve first when no compiled runner is cached — the runner is
    built inside the method's solve path (fused_solve cache_on=method)."""
    from ..solvers import solve
    from ..solvers.factory import make_method

    method = method or make_method(setup)
    if getattr(method, "_fused_runner", None) is None:
        solve(setup, method=method)
    runner = method._fused_runner
    lowered = runner._run_jit.lower(runner._init_jit())
    txt = lowered.compile().as_text()
    n = int(setup.b.shape[0] if setup.b.ndim == 1 else setup.b.size)
    return hlo_collective_census(txt, full_vector_len=n)
