"""Faults planted in the program's timed path, to see the check catch them:
the check's own tests plant them at a tiny size, control.py at a cell's
own size.  Each is a context manager that patches a module of the program
while it is open.

    state_unchanged   the plane step returns the rays' state unchanged
    half_particles    half of each plane's particles left out, the mean
                      mass taken over the rest (the plane's total kept)
    deflection        the ray side writes each ray's deflection 1 % off
"""

import contextlib

FAULTS = ("state_unchanged", "half_particles", "deflection")


def _state_unchanged(orig):
    def step(plan, tab, packed, *a, **k):
        _, maps = orig(plan, tab, packed, *a, **k)
        return packed.clone(), maps
    return step


def _half_particles(orig):
    def step(plan, tab, packed, pos, mass, *a, **k):
        h = len(mass) // 2
        return orig(plan, tab, packed, pos[:h], mass[:h] * 2.0, *a, **k)
    return step


def _deflection(orig):
    def rayside(*a, **k):
        out = orig(*a, **k)
        out[14:16] *= 1.01
        return out
    return rayside


@contextlib.contextmanager
def planted(name):
    import calclens_tpu_torch.driver as drv
    import calclens_tpu_torch.poisson as poi

    mod, attr, wrap = {
        "state_unchanged": (drv, "plane_step_packed", _state_unchanged),
        "half_particles": (drv, "plane_step_packed", _half_particles),
        "deflection": (poi, "phase_rayside", _deflection),
    }[name]
    orig = getattr(mod, attr)
    setattr(mod, attr, wrap(orig))
    try:
        yield
    finally:
        setattr(mod, attr, orig)
