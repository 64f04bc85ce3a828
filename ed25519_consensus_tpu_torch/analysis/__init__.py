"""The port's consensus-safety analysis, over the port's own code.

The port's consensus claims rest on invariants the ROADMAP states:
device math is integer-only, clocks are injected, every knob goes
through ``config``, verdicts are aggregated in submission order, secrets
never reach an output, and each shared field has one owning lock.  This
subpackage checks them, in four layers:

* **Layer 1, the AST linter** (``linter.py``): the catalog CL001-CL009
  over every ``.py`` file of ``ed25519_consensus_tpu_torch/`` (its
  ``tools/`` included) and CL001's float scan of ``csrc/``, with a
  justified waiver file (``waivers.toml``); the concurrency pair
  CL008/CL009 (``guards.py``) checks the field→lock map ``guards.toml``.
* **Layer 2, the integer-only audit**: ``ir_audit.py`` traces every torch
  twin the device paths run through a dispatch mode and holds its aten
  ops and dtypes to ``twin_manifest.json``; ``sass_audit.py`` holds the
  compiled kernels' SASS opcodes to ``sass_manifest.json``.
* **Layer 3, lock order** (``lockorder.py``): instrumented locks record
  the acquisition graph; a cycle fails.
* **Layer 4, write races** (``race_audit.py``): an Eraser lockset monitor
  over the same threads; a field two threads wrote with no common lock
  fails.  ``harness.py`` runs layers 3 and 4 over the port's threaded
  suites, or over a device workload on the card.

Nothing here imports ``jax`` or the JAX package; the CLI is
``python -m ed25519_consensus_tpu_torch.tools.consensuslint``.
"""

from . import linter  # noqa: F401  (the rule catalog is the public face)

__all__ = ["linter"]
