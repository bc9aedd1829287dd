"""Hand-written CUDA kernels (sources in `sound_bubble_tpu_torch/csrc/`),
each beside its plain PyTorch version.

Each wrapper counts the launches of its kernel in integer attributes named
`*launches` (`gridnet_stack_step.launches`, `lstm_slab_fwd.mixed_launches`,
`blstm_infer.launches`, ...), added to where the kernel is launched and
nowhere else. `launch_counts` reads them all. A CUDA graph runs no Python
when it replays, so the wrappers count its kernels once, at capture, when
nothing runs: `capture_launches` takes that count back and returns it,
`add_launches` adds it once a replay, and `count_replays` does both for a
graph already replayed."""
import functools
import importlib

# (module, wrapper) of every kernel wrapper that counts its launches
_WRAPPERS = (("stack_kernel", "gridnet_stack_step"),
             ("lstm_slab", "lstm_slab_fwd"), ("lstm_slab", "lstm_slab_bwd"),
             ("lstm_train_kernel", "lstm_seq_fwd"),
             ("lstm_train_kernel", "lstm_seq_bwd"),
             ("lstm_train_kernel", "blstm_seq_fwd"),
             ("lstm_train_kernel", "blstm_seq_bwd"),
             ("lstm_kernel", "blstm_infer"))


@functools.cache
def _counters():
    """(key, wrapper, attribute) of every counter."""
    out = []
    for module, name in _WRAPPERS:
        fn = getattr(importlib.import_module(f"{__name__}.{module}"), name)
        out += [(f"{name}.{attr}", fn, attr) for attr in sorted(vars(fn))
                if attr.endswith("launches")]
    return tuple(out)


def launch_counts() -> dict:
    """{"wrapper.attribute": count} of every launch counter."""
    return {key: getattr(fn, attr) for key, fn, attr in _counters()}


def capture_launches(before: dict) -> dict:
    """Called just after a CUDA graph's capture, with the counts read just
    before it: sets every counter back to `before` (the capture ran
    nothing) and returns the capture's launches, {key: n}, the launches of
    one replay."""
    delta = {}
    for key, fn, attr in _counters():
        delta[key] = getattr(fn, attr) - before[key]
        setattr(fn, attr, before[key])
    return delta


def add_launches(delta: dict, times: int = 1):
    """Add `times` replays of a graph whose launches `capture_launches`
    returned."""
    for key, fn, attr in _counters():
        if delta[key]:
            setattr(fn, attr, getattr(fn, attr) + delta[key] * times)


def count_replays(before: dict, replays: int):
    """Called after `replays` replays of a graph with the counts read just
    before its capture: sets each counter to what it would read had the
    graph's launches run eagerly, the capture's launches times the
    replays."""
    add_launches(capture_launches(before), replays)
