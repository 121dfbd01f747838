"""The port's refusal type.

``Refused`` is what a lowering or a launch raises for an op, an
attribute or a launch config it does not offer (an op type with no
lowering, a Pad mode, the collectives). The search scores a
candidate that raises it as inf and the tuner skips a config that raises
it. Every other error propagates: a shape check's ValueError on the card
(the G2BMM / GBMM lowerings already send the shapes the band kernels do
not take to the gather path, so a wrapper that refuses a shape they pass
is a bug) and a kernel build's or launch's RuntimeError.
"""


class Refused(NotImplementedError):
    """An op, attribute or launch config that is not offered."""
