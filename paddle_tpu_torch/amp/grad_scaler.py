"""GradScaler: dynamic loss scaling for float16.

Counterpart of ``paddle_tpu/amp/grad_scaler.py`` (:15-125): ``scale``
multiplies the loss by the scale; ``unscale_`` divides the optimizer's
gradients by it (in f32, rounded once to the gradient's dtype) and notes
whether any is inf or nan; ``step`` skips the update when one was;
``update`` halves the scale after ``decr_every_n_nan_or_inf`` bad steps
and doubles it after ``incr_every_n_steps`` good ones.  The reference
reads each gradient's finiteness back to the host; here the flags are
or-ed on the device and read once, in ``step``, where the host must
decide whether the optimizer runs.
"""
from __future__ import annotations

import torch

__all__ = ["AmpScaler", "GradScaler"]


class GradScaler:
    def __init__(self, enable=True, init_loss_scaling=65536.0,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=2000,
                 decr_every_n_nan_or_inf=1, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling) if enable else 1.0
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        self._unscaled = False

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._enable and self._dynamic

    def get_init_loss_scaling(self):
        return self._scale

    def set_init_loss_scaling(self, v):
        self._scale = float(v)

    def scale(self, var):
        if not self._enable or self._scale == 1.0:
            return var
        return var * self._scale

    @torch.no_grad()
    def unscale_(self, optimizer):
        if not self._enable:
            return
        if self._unscaled:
            raise RuntimeError(
                "unscale_() has already been called on this optimizer since "
                "the last update().")
        inv = 1.0 / self._scale
        bad = None
        for p in optimizer._parameter_list or ():
            g = p.grad
            if g is None:
                continue
            if self._scale != 1.0:
                g.copy_((g.float() * inv).to(g.dtype))
            nonfinite = ~torch.isfinite(g).all()
            bad = nonfinite if bad is None else bad | nonfinite
        self._found_inf = bad
        self._unscaled = True

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        if not self._unscaled:
            self.unscale_(optimizer)
        # the one host read of a step: whether the optimizer runs
        self._found_inf = bool(self._found_inf) \
            if self._found_inf is not None else False
        if not self._found_inf:
            optimizer.step()
        self._unscaled = False

    def update(self):
        if not self._enable or not self._dynamic:
            self._found_inf = False
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every:
                self._scale *= self._incr_ratio
                self._good_steps = 0
        self._found_inf = False

    def minimize(self, optimizer, scaled_loss):
        scaled_loss.backward()
        self.step(optimizer)
        self.update()

    def state_dict(self):
        return {"scale": self._scale, "incr_ratio": self._incr_ratio,
                "decr_ratio": self._decr_ratio,
                "incr_every_n_steps": self._incr_every,
                "decr_every_n_nan_or_inf": self._decr_every,
                "incr_count": self._good_steps,
                "decr_count": self._bad_steps,
                "use_dynamic_loss_scaling": self._dynamic}

    def load_state_dict(self, sd):
        self._scale = sd.get("scale", self._scale)
        self._good_steps = sd.get("incr_count", 0)
        self._bad_steps = sd.get("decr_count", 0)

    set_state_dict = load_state_dict


AmpScaler = GradScaler
