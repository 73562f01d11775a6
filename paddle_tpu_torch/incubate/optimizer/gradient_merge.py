"""Gradient merge: apply the inner optimizer once every ``k_steps``
micro-steps, on the (averaged) sum of their gradients.

Counterpart of ``paddle_tpu/incubate/optimizer/gradient_merge.py``.  The
wrapper looks like its inner optimizer (attributes are forwarded, and the
training step's ``_global_step`` lands on the inner one).  Eagerly,
``step()`` adds each ``p.grad`` into a per-parameter accumulator in the
gradient's dtype and, on every ``k_steps``-th call, hands the merged
gradient to ``inner.step()``.  In the training step the accumulator is
the ``gm_acc`` state (f32 for bf16 parameters, else the parameter's
dtype), and ``state_dict`` carries the partial window
(``gradient_merge_count``, ``gradient_merge_acc``) so a checkpoint taken
mid-window resumes with the exact partial sums.

The merge cannot copy the reference's select.  The reference runs the
inner update on every micro-step and keeps or discards its result with
``jnp.where(step % k == 0, ...)``; the fused int8 AdamW (K7) updates the
parameters and their state in place, so a discarded K7 update would
already have changed them.  ``functional_update`` therefore decides on
the host, from the step counter it already holds (no device read): a
non-apply step only adds the gradients into ``gm_acc`` and returns the
parameters and the inner state as they were — the same tensors, bit for
bit — and launches no optimizer kernel.  An apply step clips the merged
gradient where the training step installed a clip (``_merged_clip``, the
reference's clip of the effective gradient once per window), runs the
inner update with ``step // k_steps`` as its bias-correction step, and
zeroes ``gm_acc`` in place.  The learning rate is the one of the call,
as the reference's; its scheduler advances on every call.
"""
from __future__ import annotations

import torch

__all__ = ["GradientMergeOptimizer"]


class GradientMergeOptimizer:
    def __init__(self, inner_optimizer, k_steps=1, avg=True):
        if not (isinstance(k_steps, int) and k_steps > 0):
            raise ValueError("k_steps should be a positive integer")
        self.inner_optimizer = inner_optimizer
        self.k_steps = k_steps
        self.avg = bool(avg)
        self._acc = {}
        self._count = 0

    # -- facade: look like the wrapped optimizer ---------------------------
    def __getattr__(self, item):
        if item == "inner_optimizer":
            raise AttributeError(item)
        return getattr(self.inner_optimizer, item)

    @property
    def _global_step(self):
        return self.inner_optimizer._global_step

    @_global_step.setter
    def _global_step(self, v):
        self.inner_optimizer._global_step = v

    def _set_k_steps(self, k_steps):
        self.k_steps = k_steps

    def _set_avg(self, avg):
        self.avg = avg

    # --------------------------------------------------------------- eager
    @torch.no_grad()
    def step(self):
        inner = self.inner_optimizer
        self._count += 1
        params = inner._parameter_list or ()
        for p in params:
            if p.grad is None:
                continue
            acc = self._acc.get(id(p))
            self._acc[id(p)] = p.grad.clone() if acc is None \
                else acc + p.grad
        if self._count % self.k_steps:
            # the gradients are in the accumulator; no parameter moves
            for p in params:
                p.grad = None
            return
        for p in params:
            acc = self._acc.pop(id(p), None)
            if acc is not None:
                p.grad = acc / self.k_steps if self.avg else acc
        inner.step()

    def clear_grad(self, set_to_zero=True):
        self.inner_optimizer.clear_grad(set_to_zero)

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        self.clear_grad()

    # ----------------------------------------------------- training step
    def functional_init_states(self, params):
        states = self.inner_optimizer.functional_init_states(params)
        states["gm_acc"] = {
            k: torch.zeros(v.shape, dtype=torch.float32
                           if v.dtype == torch.bfloat16 else v.dtype,
                           device=v.device)
            for k, v in params.items()}
        return states

    @torch.no_grad()
    def functional_update(self, params, grads, states, lr):
        inner, k = self.inner_optimizer, self.k_steps
        step = int(inner._global_step)
        acc = states["gm_acc"]
        for n, g in grads.items():
            if g is not None:
                acc[n].add_(g)          # acc + g.astype(acc.dtype), exact
        inner_states = {n: v for n, v in states.items() if n != "gm_acc"}
        if step % k:
            return dict(params), dict(states)
        eff = {n: ((acc[n] / k if self.avg else acc[n].clone())
                   if g is not None else None) for n, g in grads.items()}
        merged_clip = self.__dict__.get("_merged_clip")
        if merged_clip is not None:
            eff = merged_clip(eff)
        prev = inner._global_step
        inner._global_step = step // k
        try:
            new_params, new_states = inner.functional_update(
                params, eff, inner_states, lr)
        finally:
            inner._global_step = prev
        for t in acc.values():
            t.zero_()
        new_states["gm_acc"] = acc
        return new_params, new_states

    # ------------------------------------------------------------ state
    def state_dict(self):
        sd = self.inner_optimizer.state_dict()
        sd["gradient_merge_count"] = self._count
        sd["gradient_merge_acc"] = {
            str(i): self._acc[id(p)].clone()
            for i, p in enumerate(self.inner_optimizer._parameter_list or ())
            if id(p) in self._acc}
        return sd

    def set_state_dict(self, sd):
        sd = dict(sd)
        self._count = int(sd.pop("gradient_merge_count", 0))
        acc = sd.pop("gradient_merge_acc", {})
        self._acc = {}
        for i, p in enumerate(self.inner_optimizer._parameter_list or ()):
            v = acc.get(str(i))
            if v is not None:
                self._acc[id(p)] = torch.as_tensor(v).to(p.device).clone()
        self.inner_optimizer.set_state_dict(sd)
