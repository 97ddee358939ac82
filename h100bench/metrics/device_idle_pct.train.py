"""The share of the untraced window in which no operation ran on the first
rank's device: one minus the device's busy time a step, from the union of
its operations' intervals in the traced stretch, over the window's host time
a step. The profiler's per-operation records slow a host-paced step, so the
traced stretch's own idle share (``device.busy_s`` over ``device.window_s``)
overstates the window's; it stays in the result's ``device`` and
``breakdown``."""

LAYER = "device"
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "train_impressions_per_s"


def read(rec):
    if (rec.kind != "train" or rec.trace is None or rec.step_work is None
            or rec.step_work.steps <= 0 or rec.window_s <= 0
            or not rec.counts.get("traced_steps")):
        return None
    busy_per_step = rec.counts.get("busy_s", rec.trace.busy_s) / rec.counts["traced_steps"]
    return 100.0 * (1.0 - busy_per_step / (rec.window_s / rec.step_work.steps))
