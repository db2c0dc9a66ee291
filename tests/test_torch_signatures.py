"""Every public function and method of the port takes the JAX package's
parameters: the same names, in the same order, with the same defaults.

Read from the sources with ``ast`` (neither package is imported). The
port may differ only by these renamings:

- a JAX ``key`` (a ``jax.random`` key) is a ``generator``
  (a ``torch.Generator``);
- a JAX dtype default (``jnp.float32``) is the torch dtype of that name;
- ``sim.executor.CircuitPlan.trace_probs`` takes ``flips`` where JAX takes
  ``flips_ri`` (the JAX real/imaginary plane layout is not carried);
- a trailing ``device`` parameter (where the call runs: the card by
  default), after all of JAX's.
"""
import ast
import os
import pathlib

REPO = pathlib.Path(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
JAX = REPO / "forest_benchmarking_tpu"
PORT = REPO / "forest_benchmarking_tpu_torch"
RENAMED_PARAMS = {("sim/executor.py", "CircuitPlan.trace_probs"):
                  {"flips_ri": "flips"}}


def _params(fn: ast.FunctionDef):
    """[(name, kind, default source or None)] in the call's order."""
    a = fn.args
    pos = a.posonlyargs + a.args
    defaults = [None] * (len(pos) - len(a.defaults)) + list(a.defaults)
    out = [(p.arg, "positional", d) for p, d in zip(pos, defaults)]
    if a.vararg:
        out.append((a.vararg.arg, "*args", None))
    out += [(p.arg, "keyword", d) for p, d in zip(a.kwonlyargs,
                                                  a.kw_defaults)]
    if a.kwarg:
        out.append((a.kwarg.arg, "**kwargs", None))
    return [(name, kind, None if d is None else ast.unparse(d))
            for name, kind, d in out]


def public_signatures(root: pathlib.Path):
    """{(file, name): params} of every public module-level function and
    every public method (and ``__init__``) of every public class."""
    sigs = {}
    for path in sorted(root.rglob("*.py")):
        rel = path.relative_to(root).as_posix()
        for node in ast.parse(path.read_text()).body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and not node.name.startswith("_"):
                sigs[(rel, node.name)] = _params(node)
            elif isinstance(node, ast.ClassDef) \
                    and not node.name.startswith("_"):
                for m in node.body:
                    if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                            and (not m.name.startswith("_")
                                 or m.name == "__init__"):
                        sigs[(rel, f"{node.name}.{m.name}")] = _params(m)
    return sigs


def as_jax(where, params):
    """The port's parameters under the sanctioned renamings, its trailing
    ``device`` parameters dropped."""
    while params and params[-1][0] == "device":
        params = params[:-1]
    renames = {"generator": "key", **{v: k for k, v in
                                      RENAMED_PARAMS.get(where, {}).items()}}
    return [(renames.get(name, name), kind,
             None if d is None else d.replace("torch.", "jnp."))
            for name, kind, d in params]


def gaps():
    jax, port = public_signatures(JAX), public_signatures(PORT)
    out = []
    for where, params in sorted(jax.items()):
        if where not in port:
            out.append((where, "missing in the port"))
        elif as_jax(where, port[where]) != params:
            out.append((where, params, port[where]))
    return out


def test_public_signatures_equal_jax():
    assert gaps() == []


def test_signature_reader_sees_the_renamings():
    """The comparison is not empty: it reads the renamed parameters."""
    port = public_signatures(PORT)
    jax = public_signatures(JAX)
    assert len(jax) > 300
    where = ("ops/random_operators.py", "haar_rand_unitary")
    assert jax[where][0][0] == "key" and port[where][0][0] == "generator"
    assert jax[where][-1] == ("dtype", "positional", "jnp.float64")
    assert port[where][-1] == ("dtype", "positional", "torch.float64")
    plan = ("sim/executor.py", "CircuitPlan.trace_probs")
    assert [p[0] for p in port[plan]] == ["self", "stacked", "conf", "flips"]
    sharding = ("parallel/sharding.py", "shard_map_batched")
    assert port[sharding][-1] == ("check_vma", "positional", "False")
