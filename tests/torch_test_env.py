"""Process settings of the port's tests (``tests/test_torch_*.py``), each
of which imports this module first.

* torch runs its CPU ops on one intra-op thread.  The suite runs in
  several worker processes at once (``pytest -n``); with a thread per
  core each, the workers' torch threads spin against one another.  The
  JAX package's tests do not use torch.
* JAX keeps the programs it compiles in its persistent compilation cache,
  under ``build/jax_cache/`` at the repository root (gitignored), so a
  JAX reference that many tests compile alike (the same engine steps of
  the same smoke configs) is compiled once per run and loaded after, in
  every worker.  The setting is the process's: a JAX package test that
  runs in the same worker after this import uses the cache too (the same
  programs, loaded instead of compiled).  The cache has no size limit: a
  limit makes every read and write take one file lock and scan the whole
  directory, which serialises the workers.  Without it a worker may read
  an entry another is still writing; JAX then fails to decompress it,
  warns and compiles, so such a read costs a compile and nothing else.

``test_torch_cuda.py`` runs on the card's machine, which has no JAX, and
does not import this module.
"""

from pathlib import Path

import jax
import torch

torch.set_num_threads(1)

CACHE_DIR = Path(__file__).resolve().parents[1] / "build" / "jax_cache"
jax.config.update("jax_compilation_cache_dir", str(CACHE_DIR))
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
