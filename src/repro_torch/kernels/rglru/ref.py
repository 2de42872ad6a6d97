"""Plain PyTorch oracle for the RG-LRU recurrence kernel (the counterpart
of ``repro/kernels/rglru/ref.py``): the reference's associative scan as a
log-depth (Hillis–Steele) scan in float32, combining (a_l, b_l) then
(a_r, b_r) into (a_l·a_r, a_r·b_l + b_r)."""


def rglru_ref(a, b):
    import torch
    A, H = a.float(), b.float()
    shift, S = 1, a.shape[1]
    while shift < S:
        H = torch.cat([H[:, :shift], A[:, shift:] * H[:, :-shift]
                       + H[:, shift:]], dim=1)
        A = torch.cat([A[:, :shift], A[:, shift:] * A[:, :-shift]], dim=1)
        shift *= 2
    return H.to(a.dtype)
