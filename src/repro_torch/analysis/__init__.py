"""blasxcheck for the PyTorch port: lock-discipline, lock-order,
determinism and assertion-strength analyses over ``src/repro_torch``,
plus the runtime lock-witness.

Static side (stdlib ``ast`` only: importing this package loads neither
torch nor numpy, so the gate runs straight off a checkout):

* :func:`repro_torch.analysis.locks.check_lock_discipline` — LD001/
  LD002/LD003 against the ``_GUARDED_BY`` declarations;
* :func:`repro_torch.analysis.locks.check_lock_order` — LO001 cycles in
  the cross-module acquisition graph;
* :func:`repro_torch.analysis.determinism.check_determinism` — DT001/
  DT002 wall-clock / ambient-RNG leaks (numpy's and torch's global
  generators included) into the port's virtual-clock paths;
* :func:`repro_torch.analysis.assertions.check_assertions` — AS001/
  AS002 tautological invariant checks.

Dynamic side: :class:`repro_torch.analysis.witness.LockWitness` wraps
locks allocated from the port's source and from the tests during
threads-mode runs and reports lock-order inversions with both
acquisition stacks (``-p repro_torch.analysis.pytest_witness`` runs a
whole pytest session under it).

CLI: ``python -m repro_torch.analysis --strict src/repro_torch``;
``--witness-smoke`` drives a threads-mode workload under the witness
(on the card, or on the host with ``--device cpu``).
"""
from .cli import main, run_analyses
from .findings import Baseline, Finding, RULES
from .witness import LockWitness

__all__ = ["main", "run_analyses", "Baseline", "Finding", "RULES",
           "LockWitness"]
