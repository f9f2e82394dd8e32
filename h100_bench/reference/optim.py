"""The reference's optimizer: the configuration's AdamW, written out plainly.

Global-norm clip to ``grad_clip``; AdamW (bias-corrected moments, decoupled
weight decay) for ordinary leaves; for a Dense weight of ``factored_threshold``
elements or more, Adafactor's factored second moment (row and column means of
g^2 + eps^2 with the decay 1 - t^-beta2, rows normalized by their mean), an
undebiased EMA momentum and decoupled weight decay; the learning rate from a
cosine schedule without warm-up.  Everything in float32, on float32
parameters.
"""

from __future__ import annotations

import math

import torch


class RefOptimizer:
    def __init__(self, named_params: dict, dense_weights: set, training: dict,
                 steps_per_epoch: int):
        opt = training.get("optimizer", {})
        sched = training.get("scheduler", {})
        if int(sched.get("warmup_epochs", 0)) != 0 or sched.get("name", "cosine") != "cosine":
            raise NotImplementedError("the reference schedule is cosine without warm-up")
        if int(training.get("accumulation_steps", 1)) != 1:
            raise NotImplementedError("the reference takes one micro-step an update")
        self.params = named_params
        self.b1, self.b2 = (float(b) for b in opt.get("betas", [0.9, 0.999]))
        self.eps = float(opt.get("eps", 1e-8))
        self.wd = float(opt.get("weight_decay", 0.05))
        self.lr0 = float(opt.get("lr", 3e-4))
        self.alpha = float(sched.get("min_lr", 1e-6)) / self.lr0
        self.total = max(int(training.get("epochs", 100)) * steps_per_epoch, 1)
        self.clip = float(training.get("grad_clip", 1.0))
        threshold = int(opt.get("factored_threshold", 32_000_000))
        factored_on = bool(opt.get("factored_large_leaves", True))
        self.t = 0
        self.state = {}
        for name, p in named_params.items():
            axes = None
            if factored_on and p.dim() == 2 and p.numel() >= threshold:
                if name not in dense_weights or p.shape[0] == p.shape[1] or min(p.shape) < 128:
                    raise NotImplementedError(f"{name}: the reference factors only Dense "
                                              "weights that are not square, both sides >= 128")
                # statistics along the leaf's smaller axis (rows) and larger (columns)
                axes = tuple(sorted(range(2), key=lambda i: p.shape[i]))
            if axes is None:
                self.state[name] = {"m": torch.zeros_like(p), "v": torch.zeros_like(p)}
            else:
                self.state[name] = {"axes": axes, "ema": torch.zeros_like(p),
                                    "v_row": torch.zeros(p.shape[axes[0]], device=p.device),
                                    "v_col": torch.zeros(p.shape[axes[1]], device=p.device)}

    def lr(self, count: int) -> float:
        c = min(count, self.total)
        cos = 0.5 * (1 + math.cos(math.pi * c / self.total))
        return self.lr0 * ((1 - self.alpha) * cos + self.alpha)

    @torch.no_grad()
    def step(self, on_gradient=None) -> None:
        """One update from each parameter's ``.grad``; ``on_gradient(name,
        g)`` sees each clipped gradient first."""
        grads = {n: p.grad for n, p in self.params.items()}
        norm = torch.linalg.vector_norm(torch.stack([g.norm() for g in grads.values()]))
        scale = min(self.clip / max(float(norm), 1e-16), 1.0) if self.clip > 0 else 1.0
        lr = self.lr(self.t)
        self.t += 1
        t = self.t
        for name, p in self.params.items():
            g = grads[name] * scale
            if on_gradient is not None:
                on_gradient(name, g)
            st = self.state[name]
            if "m" in st:
                st["m"].mul_(self.b1).add_(g, alpha=1 - self.b1)
                st["v"].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
                denom = (st["v"] / (1 - self.b2 ** t)).sqrt_().add_(self.eps)
                p.mul_(1 - lr * self.wd).addcdiv_(st["m"], denom, value=-lr / (1 - self.b1 ** t))
                continue
            rows, cols = st["axes"]
            decay = 1.0 - float(t) ** (-self.b2)
            gsq = g * g + self.eps ** 2
            st["v_row"].mul_(decay).add_(gsq.mean(dim=cols), alpha=1 - decay)
            st["v_col"].mul_(decay).add_(gsq.mean(dim=rows), alpha=1 - decay)
            u = g * (st["v_row"] / st["v_row"].mean()).rsqrt().unsqueeze(cols)
            u = u * st["v_col"].rsqrt().unsqueeze(rows)
            st["ema"].mul_(self.b1).add_(u, alpha=1 - self.b1)
            p.add_(st["ema"] + self.wd * p, alpha=-lr)
