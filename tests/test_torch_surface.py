"""The port's public surface against the JAX package's.

Every module of ``arrowspace_tpu`` (``__main__`` and the C++ ``native``
package skipped, as tests/test_api_surface.py does) has a counterpart in
``arrowspace_torch``: the module of the same name, or for the Pallas
kernel modules the module the port renamed it to (PORT_MODULES).  A user
moving from one package to the other must meet no AttributeError,
ImportError or TypeError, so:

1. every ``__all__`` name (every public name the module defines, where it
   has no ``__all__``) resolves in the counterpart;
2. every parameter name of each public function, and of each public
   method of each public class (a dataclass's fields too), is accepted by
   the counterpart (by name, or through its ``**kwargs``).

The only exceptions are NOT_PORTED: names and parameters that exist for
XLA or the TPU (compile caches and buckets, Pallas tile and layout
knobs, interpret mode, mesh axis names) and the energy kernel wrappers'
operand-packaging parameters, where the port passes a prepared engine's
tensors.  Each carries its reason, in agreement with ROADMAP.md's "Not
ported at all".  A second test holds every listed name to really being
missing, so the list cannot go stale."""

import dataclasses
import importlib
import inspect
import pkgutil

import pytest

import arrowspace_tpu

_SKIP_SUFFIXES = (".__main__",)

# JAX module (relative name) -> the port's modules that hold its surface
PORT_MODULES = {
    "ops.pallas_bintopk": ("ops.bintopk", "ops.energy_bintopk"),
    "ops.pallas_topk": ("ops.topk",),
    "ops.pallas_tau": ("ops.select_tau",),
    "ops.pallas_taulambda": ("ops.taulambda",),
    "ops.pallas_lambda": ("ops.lambda_batch",),
    "native.clustering_native": ("native",),
}

_PALLAS = ("a Pallas grid knob (VMEM tile, block or lane layout) of the "
           "TPU kernel; the CUDA kernel picks its CTA shape from F and B")
_INTERPRET = ("Pallas interpret mode, which runs a TPU kernel on the CPU; "
              "the port's wrappers take the plain version for a CPU tensor")
_BUCKET = ("padding keyed on the TPU kernel's Pallas layout (bsz, k, depth) "
           "to bound XLA recompiles; the port pads a prepared corpus to "
           "CORPUS_ALIGN rows for every batch and k")
_ENERGY_PACKAGING = ("the JAX energy kernel's operand packaging (raw or "
                     "prepared z-plane, norms, weights as arrays, the live "
                     "count); the port's wrapper takes the prepared "
                     "engine's tensors (ops.bin_repair.BinnedEnergyTopK)")
_RETURN_DET = ("drops an output buffer from the jitted XLA program; the "
               "port's flush always returns det beside the flags")

NOT_PORTED = {
    # config: the XLA compile cache and its dtype switch
    "config.setup_cache": "the persistent XLA compilation cache; the "
                          "port's kernels are one nvcc library built once",
    "config.bucket_rows": "row buckets that bound Mosaic recompiles; "
                          "nothing on the CUDA path compiles per shape",
    "config.default_dtype": "the x64 switch of JAX; the port takes an "
                            "explicit dtype (config.resolve)",
    # taumode: XLA precision of the query-prep matmul
    "taumode.QUERY_PREP_PRECISION": "jax.lax.Precision for the TPU MXU; "
                                    "TF32 is off for every product here",
    "taumode.synthetic_lambda_batch(precision)":
        "jax.lax.Precision for the TPU MXU; TF32 is off for every product",
    # precompile: the AOT program list and cache
    "precompile.centroid_cap_buckets": "the XLA centroid-cap programs "
                                       "precompile AOT-compiles per bucket",
    "precompile.warm(cache_path)": "the persistent XLA compile cache",
    "precompile.warm_energy(cache_path)": "the persistent XLA compile cache",
    "precompile.warm_energy(taumode)":
        "selects the fused XLA session-step program compiled per τ policy; "
        "the port's query-λ preparation compiles nothing per policy",
    # bin_repair
    "ops.bin_repair.padded_take": "power-of-two index buckets that bound "
                                  "XLA recompiles of the repair gathers",
    "ops.bin_repair.strided_energy_repair(z_items)": _ENERGY_PACKAGING,
    "ops.bin_repair.strided_energy_repair(item_lambdas)": _ENERGY_PACKAGING,
    "ops.bin_repair.strided_energy_repair(z_norms)": _ENERGY_PACKAGING,
    "ops.bin_repair.strided_energy_repair(prepared)": _ENERGY_PACKAGING,
    # mesh
    "parallel.mesh.make_mesh(axis_name)": "the jax.sharding mesh axis name; "
                                          "the port's Mesh is a device list",
    # K1 / K6 (pallas_bintopk)
    "ops.pallas_bintopk.binned_layout": "the TPU kernel's Pallas layout "
                                        "resolution (block, tile, lanes)",
    "ops.pallas_bintopk.binned_energy_layout": "the TPU energy kernel's "
                                               "Pallas layout resolution",
    "ops.pallas_bintopk.binned_lambda_topk(tile)": _PALLAS,
    "ops.pallas_bintopk.binned_lambda_topk(block_b)": _PALLAS,
    "ops.pallas_bintopk.binned_lambda_topk(lane_split)": _PALLAS,
    "ops.pallas_bintopk.binned_lambda_topk(pre_reduce)": _PALLAS,
    "ops.pallas_bintopk.binned_lambda_topk(interpret)": _INTERPRET,
    "ops.pallas_bintopk.binned_lambda_topk(return_det)": _RETURN_DET,
    "ops.pallas_bintopk.binned_lambda_topk(n_live)":
        "a traced live count beside the static n_items, so that one XLA "
        "program serves every count; the port's n_items is read at each "
        "call",
    "ops.pallas_bintopk.prepare_binned_corpus(bsz)": _BUCKET,
    "ops.pallas_bintopk.prepare_binned_corpus(k)": _BUCKET,
    "ops.pallas_bintopk.prepare_binned_corpus(depth)": _BUCKET,
    "ops.pallas_bintopk.prepare_binned_energy_corpus(bsz)": _BUCKET,
    "ops.pallas_bintopk.prepare_binned_energy_corpus(k)": _BUCKET,
    "ops.pallas_bintopk.prepare_binned_energy_corpus(depth)": _BUCKET,
    **{f"ops.pallas_bintopk.binned_energy_topk({p})": _ENERGY_PACKAGING
       for p in ("z_items", "item_lambdas", "w_lambda", "w_dirichlet",
                 "prepared", "n_items", "z_norms", "n_live")},
    **{f"ops.pallas_bintopk.binned_energy_topk({p})": _PALLAS
       for p in ("tile", "block_b", "lane_split", "pre_reduce")},
    "ops.pallas_bintopk.binned_energy_topk(interpret)": _INTERPRET,
    "ops.pallas_bintopk.binned_energy_topk(return_det)": _RETURN_DET,
    "ops.pallas_bintopk.binned_energy_topk(score_form)":
        "the TPU kernel's legacy score_form='div' (ROADMAP: not ported)",
    # K7
    **{f"ops.energy_approx.binned_energy_topk_approx({p})": _ENERGY_PACKAGING
       for p in ("z_items", "item_lambdas", "w_lambda", "w_dirichlet",
                 "n_items", "z_norms")},
    **{f"ops.energy_approx.binned_energy_topk_approx({p})": _PALLAS
       for p in ("tile", "block_b", "lane_split", "pre_reduce")},
    "ops.energy_approx.binned_energy_topk_approx(interpret)": _INTERPRET,
    "ops.energy_approx.prepare_energy_chord_sample(z_prepared)":
        _ENERGY_PACKAGING,
    "ops.energy_approx.prepare_energy_chord_sample(z_norms)":
        _ENERGY_PACKAGING,
    # K3, K4, K2, K5
    "ops.pallas_topk.pallas_available": "whether JAX's backend is a TPU; "
                                        "the port's kernels run on any "
                                        "CUDA tensor",
    "ops.pallas_topk.fused_lambda_topk(tile)": _PALLAS,
    "ops.pallas_topk.fused_lambda_topk(interpret)": _INTERPRET,
    "ops.pallas_tau.fused_select_tau_fits(tile)": _PALLAS,
    "ops.pallas_tau.fused_select_tau(tile)": _PALLAS,
    "ops.pallas_tau.fused_select_tau(layout)": _PALLAS,
    "ops.pallas_tau.fused_select_tau(interpret)": _INTERPRET,
    "ops.pallas_taulambda.fused_taulambda_fits(tile)": _PALLAS,
    "ops.pallas_taulambda.fused_taulambda_batch(tile)": _PALLAS,
    "ops.pallas_taulambda.fused_taulambda_batch(layout)": _PALLAS,
    "ops.pallas_taulambda.fused_taulambda_batch(interpret)": _INTERPRET,
    "ops.pallas_lambda.fused_lambda_batch(tile)": _PALLAS,
    "ops.pallas_lambda.fused_lambda_batch(interpret)": _INTERPRET,
    # ops.search's JAX kernel wrapper
    "ops.search.pallas_binned_topk_with_repair(tile)": _PALLAS,
    "ops.search.pallas_binned_topk_with_repair(block_b)": _PALLAS,
    "ops.search.pallas_binned_topk_with_repair(lane_split)": _PALLAS,
    "ops.search.pallas_binned_topk_with_repair(pre_reduce)": _PALLAS,
    "ops.search.pallas_binned_topk_with_repair(interpret)": _INTERPRET,
}


def _jax_modules():
    pkg = arrowspace_tpu
    yield "", pkg
    for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        rel = info.name[len(pkg.__name__) + 1:]
        if info.name.endswith(_SKIP_SUFFIXES):
            continue
        if rel.startswith("native") and rel not in PORT_MODULES:
            continue
        yield rel, importlib.import_module(info.name)


def _port_modules(rel):
    names = PORT_MODULES.get(rel, (rel,))
    return [importlib.import_module(
        "arrowspace_torch" + (f".{n}" if n else "")) for n in names]


def _public_names(mod):
    if hasattr(mod, "__all__"):
        return list(mod.__all__)
    return [n for n, v in vars(mod).items() if not n.startswith("_")
            and getattr(v, "__module__", None) == mod.__name__]


def _params(fn):
    """(parameter names bar self/cls, whether it takes **kwargs)."""
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return [], False
    ps = [p for p in sig.parameters.values() if p.name not in ("self", "cls")]
    names = [p.name for p in ps
             if p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)]
    return names, any(p.kind == p.VAR_KEYWORD for p in ps)


def _find(mods, name):
    for m in mods:
        if hasattr(m, name):
            return getattr(m, name)
    return None


def _members(cls):
    """Public methods of a class (its own and inherited from the
    package), with __init__; properties are checked by name only."""
    out = {}
    for klass in reversed(cls.__mro__):
        if not klass.__module__.startswith("arrowspace_tpu"):
            continue            # builtins (dict, Exception, ...)
        for name, v in vars(klass).items():
            if name.startswith("_") and name != "__init__":
                continue
            if isinstance(v, (staticmethod, classmethod)):
                v = v.__func__
            if callable(v) or isinstance(v, property):
                out[name] = v
    return out


def _import_the_port():
    """Every module of the port, so that methods a module attaches to a
    class of another (energymaps onto ArrowSpace, as the reference's
    trait impls) are there whatever the tests imported before."""
    import arrowspace_torch
    for info in pkgutil.walk_packages(arrowspace_torch.__path__,
                                      "arrowspace_torch."):
        if not info.name.endswith(_SKIP_SUFFIXES):
            importlib.import_module(info.name)


def surface_gaps():
    """Every name or parameter of the JAX package's public surface that
    the port lacks, as NOT_PORTED keys.  Both packages are imported
    whole first, so the classes carry every method their modules
    attach."""
    gaps = []
    modules = list(_jax_modules())
    _import_the_port()
    for rel, mod in modules:
        pre = f"{rel}." if rel else ""
        ports = _port_modules(rel)
        for name in _public_names(mod):
            src, dst = getattr(mod, name, None), _find(ports, name)
            if dst is None:
                gaps.append(pre + name)
                continue
            pairs = [(name, src, dst)]
            if inspect.isclass(src):
                if not inspect.isclass(dst):
                    gaps.append(pre + name)
                    continue
                for mname, mv in _members(src).items():
                    dv = getattr(dst, mname, None)
                    if dv is None:
                        gaps.append(f"{pre}{name}.{mname}")
                    elif not isinstance(mv, property):
                        pairs.append((f"{name}.{mname}", mv, dv))
                if dataclasses.is_dataclass(src):
                    have = {f.name for f in dataclasses.fields(dst)} \
                        if dataclasses.is_dataclass(dst) else set()
                    gaps += [f"{pre}{name}.{f.name}"
                             for f in dataclasses.fields(src)
                             if not f.name.startswith("_")
                             and f.name not in have
                             and not hasattr(dst, f.name)]
            for qual, s, d in pairs:
                if not callable(s) or not callable(d):
                    continue
                want, _ = _params(s)
                have, var_kw = _params(d)
                gaps += [f"{pre}{qual}({p})" for p in want
                         if p not in have and not var_kw]
    return sorted(set(gaps))


def test_every_jax_name_and_parameter_has_a_counterpart():
    gaps = [g for g in surface_gaps() if g not in NOT_PORTED]
    assert not gaps, (
        "names or parameters of arrowspace_tpu missing from "
        f"arrowspace_torch: {gaps}; port them, or list them in NOT_PORTED "
        "with the XLA/TPU reason")


def test_not_ported_list_is_not_stale():
    gaps = set(surface_gaps())
    # the list also names a constant the walk does not reach (no __all__
    # entry): hold it to the port by hand
    from arrowspace_torch import taumode
    manual = {"taumode.QUERY_PREP_PRECISION":
              not hasattr(taumode, "QUERY_PREP_PRECISION")}
    stale = [k for k in NOT_PORTED
             if not manual.get(k, k in gaps)]
    assert not stale, f"NOT_PORTED names the port now has: {stale}"


@pytest.mark.parametrize("key", sorted(NOT_PORTED))
def test_every_exception_has_a_reason(key):
    assert len(NOT_PORTED[key]) > 20, key


def test_the_kernel_module_map_resolves():
    for rel, ports in PORT_MODULES.items():
        importlib.import_module(f"arrowspace_tpu.{rel}")
        for p in ports:
            importlib.import_module(f"arrowspace_torch.{p}")


def test_shared_names_are_documented_in_the_api_reference():
    """tests/test_api_surface.py holds docs/API.md to every ``__all__``
    name of the JAX package.  The port has no reference of its own: its
    users read docs/API.md, so every ``__all__`` name of a port module
    that its JAX counterpart also exports must appear there (the names
    the port adds, kernel wrappers and plain versions, are its
    implementation, described in README.md's port section)."""
    import pathlib
    text = (pathlib.Path(__file__).resolve().parents[1] / "docs" /
            "API.md").read_text()
    missing = []
    for rel, mod in _jax_modules():
        if not rel:
            continue
        shared = set(getattr(mod, "__all__", ()))
        for port in _port_modules(rel):
            for name in getattr(port, "__all__", ()):
                if name in shared and name not in text:
                    missing.append(f"{port.__name__}.{name}")
    assert not missing, f"shared names missing from docs/API.md: {missing}"
