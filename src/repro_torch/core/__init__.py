"""repro_torch.core — the BLASX runtime on PyTorch: tile algebra,
two-level tile caches (ALRU + MESI-X), the locality-aware dynamic
scheduling runtime, and the legacy array-in/array-out L3 BLAS API.

The public names are resolved lazily (PEP 562), so importing a leaf
module such as ``repro_torch.core.dtypes`` — which the kernels and
backends do — does not pull in the runtime, which itself imports the
backends.  ``BlasxContext`` and ``MatrixHandle`` come from
``repro_torch.api``.
"""
import importlib

_EXPORTS = {
    "blas3": ("gemm", "syrk", "syr2k", "symm", "trmm", "trsm", "shadow_run",
              "ref_gemm", "ref_syrk", "ref_syr2k", "ref_symm", "ref_trmm",
              "ref_trsm"),
    "dtypes": ("SUPPORTED_DTYPES", "canonical_dtype", "promote_dtypes",
               "validate_backend_dtype"),
    "runtime": ("BlasxRuntime", "RuntimeConfig", "config_from_reference"),
    "tiling": ("TiledMatrix", "TileGrid", "TileKey", "degree_of_parallelism"),
    "..api": ("BlasxContext", "MatrixHandle", "default_context",
              "set_default_context"),
}
_WHERE = {name: mod for mod, names in _EXPORTS.items() for name in names}

__all__ = sorted(_WHERE)


def __getattr__(name):
    mod = _WHERE.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    target = "repro_torch.api" if mod == "..api" else f"{__name__}.{mod}"
    return getattr(importlib.import_module(target), name)
