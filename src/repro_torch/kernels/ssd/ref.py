"""Plain PyTorch oracle for the SSD chunk-state scan (the counterpart of
``repro/kernels/ssd/ref.py``), written apart from the kernel's loop: each
carried-in state as its closed sum h_c = Σ_{j<c} (Π_{j<i<c} decay_i)·
state_j, in float32.  Products only, never divided out, so nothing
underflows that the recurrence itself keeps."""


def ssd_chunk_scan_ref(states, decay):
    """states: (nc, BH, P, N); decay: (nc, BH, 1, 1) -> carried-in states."""
    import torch
    st, dec = states.float(), decay.float()
    nc = st.shape[0]
    prevs = []
    for c in range(nc):
        h, w = torch.zeros_like(st[0]), torch.ones_like(dec[0])
        for j in range(c - 1, -1, -1):      # w = Π_{j<i<c} decay_i
            h = h + w * st[j]
            w = w * dec[j]
        prevs.append(h)
    return torch.stack(prevs, dim=0).to(states.dtype)
