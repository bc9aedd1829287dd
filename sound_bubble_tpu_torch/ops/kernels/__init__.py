"""Hand-written CUDA kernels (sources in `sound_bubble_tpu_torch/csrc/`),
each beside its plain PyTorch version.

Each wrapper counts the launches of its kernel in integer attributes named
`*launches` (`gridnet_stack_step.launches`, `lstm_slab_fwd.mixed_launches`,
`blstm_infer.launches`, ...), added to where the kernel is launched and
nowhere else. `launch_counts` reads them all; `count_replays` turns the
counts of a captured CUDA graph into counts of its replays."""
import importlib

# (module, wrapper) of every kernel wrapper that counts its launches
_WRAPPERS = (("stack_kernel", "gridnet_stack_step"),
             ("lstm_slab", "lstm_slab_fwd"), ("lstm_slab", "lstm_slab_bwd"),
             ("lstm_train_kernel", "lstm_seq_fwd"),
             ("lstm_train_kernel", "lstm_seq_bwd"),
             ("lstm_train_kernel", "blstm_seq_fwd"),
             ("lstm_train_kernel", "blstm_seq_bwd"),
             ("lstm_kernel", "blstm_infer"))


def _counters():
    for module, name in _WRAPPERS:
        fn = getattr(importlib.import_module(f"{__name__}.{module}"), name)
        for attr in sorted(vars(fn)):
            if attr.endswith("launches"):
                yield f"{name}.{attr}", fn, attr


def launch_counts() -> dict:
    """{"wrapper.attribute": count} of every launch counter."""
    return {key: getattr(fn, attr) for key, fn, attr in _counters()}


def count_replays(before: dict, replays: int):
    """A CUDA graph runs no Python when it replays, so the wrappers count
    its kernels once, at capture. Called after `replays` replays with the
    counts read just before the capture, this sets each counter to what it
    would read had the graph's launches run eagerly: the capture's launches
    times the replays."""
    for key, fn, attr in _counters():
        setattr(fn, attr, before[key] + (getattr(fn, attr) - before[key])
                * replays)
