"""Training: the counterpart of the reference's ``repro.train``.

``make_train_step`` / ``Trainer`` (eager steps through ``Model.loss`` and
``torch.autograd.grad``), ``AdamW`` (updates in place), ``checkpoint``
(the reference's ``.npz`` format) and ``data`` (its synthetic corpus).
"""

from repro_torch.train.optimizer import AdamW, AdamWState, adamw  # noqa: F401
from repro_torch.train.trainer import Trainer, make_train_step  # noqa: F401
