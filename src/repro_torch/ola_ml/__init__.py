"""OLA-RAW as a training-framework feature (counterpart of
``repro.ola_ml``).

* :mod:`verify`    — PTF-style ingest verification gating the trainer.
* :mod:`eval_ola`  — evaluation with bi-level early termination.
* :mod:`gradnoise` — gradient-noise-scale estimation with Eq. (3) bounds.
"""

from repro_torch.ola_ml.eval_ola import ola_eval
from repro_torch.ola_ml.verify import IngestGate

__all__ = ["IngestGate", "ola_eval"]
