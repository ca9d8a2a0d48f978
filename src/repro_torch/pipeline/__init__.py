"""``repro_torch.pipeline`` — the port's fusion pipeline:
``compile(graph, dims, options=CompileOptions(...))`` fuses, stabilizes,
selects (or autotunes, analytic or measured) and lowers a block program
to the ``py``, ``torch`` or ``cuda`` backend (see ``driver.py``), and
caches the result in a two-level :class:`KernelCache`: in-process
callables and on-disk plans under ``$REPRO_TORCH_KERNEL_CACHE``
(``cache.py``).  Lowering walks the resilience ladder (grouped ->
ungrouped -> torch -> interpreter, the last on the CPU only; see
``repro_torch.resilience``) under the ``CompileOptions.resilience``
policy, every attempt recorded in ``CompiledKernel.resilience_report``."""

from repro_torch.pipeline.cache import (CODEGEN_VERSION, CacheKey, CachePlan,
                                        CacheStats, KernelCache,
                                        default_cache, reset_default_cache)
from repro_torch.pipeline.driver import (AUTOTUNE_OBJECTIVES, BACKENDS,
                                         STATS, CompiledKernel,
                                         autotune_candidates, compile)
from repro_torch.pipeline.options import DEFAULT_OPTIONS, CompileOptions
from repro_torch.resilience import LADDER, LadderError, ResiliencePolicy

__all__ = ["AUTOTUNE_OBJECTIVES", "BACKENDS", "CODEGEN_VERSION", "CacheKey",
           "CachePlan", "CacheStats", "CompileOptions", "CompiledKernel",
           "DEFAULT_OPTIONS", "KernelCache", "LADDER", "LadderError",
           "ResiliencePolicy", "STATS", "autotune_candidates", "compile",
           "default_cache", "reset_default_cache"]
