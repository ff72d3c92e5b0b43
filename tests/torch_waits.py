"""The port's tests' count of the host's explicit waits for the device."""

import torch


def counted_waits(monkeypatch, calls: dict, key: str = "sync"):
    """Count into calls[key] every call of torch.cuda.synchronize and of a
    CUDA stream's or event's synchronize: the host's explicit waits for the
    device."""

    def counted(fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    calls.setdefault(key, 0)
    for owner in (torch.cuda, torch.cuda.Stream, torch.cuda.Event):
        monkeypatch.setattr(owner, "synchronize",
                            counted(owner.synchronize))
    return calls
