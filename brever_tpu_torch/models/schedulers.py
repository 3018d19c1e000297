"""Host-side learning-rate schedulers (counterpart of
``brever_tpu/models/schedulers.py``).

The schedule's state lives in the model family and goes into checkpoints
through ``extra_state``; a change of learning rate reaches the optimizer
through ``on_validate`` and the trainer, which keeps Adam's moments.
"""


class ReduceLROnPlateau:
    """Multiply the learning rate by ``factor`` when the monitored value
    has not improved for more than ``patience`` validations (torch
    ``ReduceLROnPlateau`` semantics)."""

    def __init__(self, init_lr, factor=0.5, patience=3, mode='min'):
        self.lr = init_lr
        self.factor = factor
        self.patience = patience
        self.mode = mode
        self.best = None
        self.num_bad = 0

    def step(self, value):
        """Returns the new learning rate if it changed, else None."""
        value = float(value)
        improved = (
            self.best is None
            or (self.mode == 'min' and value < self.best)
            or (self.mode == 'max' and value > self.best)
        )
        if improved:
            self.best = value
            self.num_bad = 0
            return None
        self.num_bad += 1
        if self.num_bad > self.patience:
            self.lr *= self.factor
            self.num_bad = 0
            return self.lr
        return None

    def state_dict(self):
        return {'lr': self.lr, 'best': self.best, 'num_bad': self.num_bad}

    def load_state_dict(self, state):
        self.lr = state['lr']
        self.best = state['best']
        self.num_bad = state['num_bad']
