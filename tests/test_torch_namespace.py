"""Namespace parity of the port against the JAX package.

Each public namespace of ``dprox_tpu`` (top level, utils, linop, proxfn,
linalg, models, algo, contrib, contrib.optic, parallel) is held against its
``dprox_tpu_torch`` counterpart: every public name the JAX package
defines there has a same-named counterpart in the port, unless ALLOW
below excludes it with its reason. Every submodule of both packages is
imported first, so a name that an import elsewhere adds to a namespace
(a subpackage attribute) is on both sides whatever ran before.
"""
import importlib
import pkgutil
import types

import pytest

import dprox_tpu
import dprox_tpu_torch

NAMESPACES = ("", "utils", "linop", "proxfn", "linalg", "models", "algo", "contrib",
              "contrib.optic", "parallel")

# (namespace, name) -> the reason the port has no same-named counterpart
ALLOW = {
    ("models", "torch_to_flax"): "ROADMAP 'Not to be ported': the torch->flax converters are "
                                 "the wrong direction; the port loads torch checkpoints as "
                                 "they are",
    ("utils", "to_jax_array"): "names JAX's array type; the port's converter is "
                               "utils.to_tensor (dp.tensor), as to_jax_array is dp.tensor "
                               "in the JAX package",
    ("contrib", "mosaicing_jax"): "names JAX's array type; the port's one mosaicing takes "
                                  "tensors and numpy arrays (contrib.mosaicing and "
                                  "mosaicing_np)",
}


def _import_all(pkg):
    for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        importlib.import_module(info.name)


def public_names(mod):
    """The names ``mod`` defines for its users: the package's own functions,
    classes and submodules, and plain constants (as
    tests/test_namespace_parity.py counts them)."""
    out = set()
    for n in dir(mod):
        if n.startswith("_"):
            continue
        v = getattr(mod, n)
        if isinstance(v, types.ModuleType):
            if getattr(v, "__name__", "").startswith("dprox_tpu"):
                out.add(n)
            continue
        if (getattr(v, "__module__", "") or "").startswith("dprox_tpu") or isinstance(
                v, (int, float, str)):
            out.add(n)
    return out


@pytest.fixture(scope="module")
def both_imported():
    _import_all(dprox_tpu)
    _import_all(dprox_tpu_torch)


def _module(pkg, ns):
    return importlib.import_module(pkg.__name__ + ("." + ns if ns else ""))


@pytest.mark.parametrize("ns", NAMESPACES, ids=lambda ns: ns or "top")
def test_namespace_parity(both_imported, ns):
    jmod, tmod = _module(dprox_tpu, ns), _module(dprox_tpu_torch, ns)
    missing = sorted(n for n in public_names(jmod)
                     if not hasattr(tmod, n) and (ns, n) not in ALLOW)
    assert not missing, f"dprox_tpu_torch.{ns or '<top>'} lacks {missing}"


def test_every_exclusion_is_still_needed_and_has_a_reason(both_imported):
    """An exclusion names a JAX name the port still lacks, with a reason."""
    for (ns, name), reason in ALLOW.items():
        assert reason.strip()
        assert name in public_names(_module(dprox_tpu, ns)), (ns, name)
        assert not hasattr(_module(dprox_tpu_torch, ns), name), (ns, name)


def test_the_port_imports_no_jax():
    """No module of the port imports jax or the JAX package (read from the
    sources, so the test holds whatever the process has imported)."""
    import ast
    import pathlib

    root = pathlib.Path(dprox_tpu_torch.__file__).parent
    bad = []
    for path in sorted(root.rglob("*.py")) + [root.parent / "chip_smoke.py"]:
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            bad += [f"{path.name}: {n}" for n in names
                    if n.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "dprox_tpu")]
    assert not bad, bad
