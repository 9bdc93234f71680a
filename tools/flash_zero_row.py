"""Where the 16-bit dQ kernel's worst error / limit sits, on the card.

Runs the dQ kernel and its plain version at the slice's shape (B=4, H=8,
S=2048, D=64, causal, the inputs of ``chip_smoke.make_inputs``) in fp16
and bf16, and prints, for a row floor of 2^-8 and 2^-5 of the tensor's
RMS, the rows with the largest error / limit (``chip_smoke.TOLS``), with
dQ's first row on both sides: at Sq == Skv that query sees one key, its
exact dQ is 0, and both sides hold fp32 residue there. It is the
measurement behind ``chip_smoke.RESIDUE_FLOOR``. Run from the repo root
on a machine with a card::

    python3 -m tools.flash_zero_row
"""

import sys

import torch


def main() -> int:
    import chip_smoke as cs
    from horovod_tpu_torch.ops import flash_attention as fa

    if not torch.cuda.is_available():
        print("flash_zero_row: no CUDA device", file=sys.stderr)
        return 1
    print("card: %s" % cs.card_line())
    b, h, s, d = cs.SLICE_SHAPE
    scale = d ** -0.5
    for dtype in (torch.float16, torch.bfloat16):
        q, k, v, do = cs.make_inputs(torch, b, h, s, s, d, dtype, "cuda",
                                     cs.SEED)
        o, lse = fa.flash_fwd_plain(q, k, v, True, scale)
        args = (q, k, v, do, lse, (do.float() * o.float()).sum(-1), True,
                scale)
        got = fa.flash_bwd_dq(*args).float()
        want = fa.flash_bwd_dq_plain(*args).float()
        rtol, atol = cs.TOLS[str(dtype)[6:]]
        rms_t = float(want.pow(2).mean().sqrt())
        for floor in (2 ** -8, 2 ** -5):
            rms = want.pow(2).mean(-1, keepdim=True).sqrt().clamp(
                min=floor * rms_t)
            worst = ((got - want).abs() / (rtol * want.abs() + atol * rms)
                     ).amax(-1).flatten()
            top = torch.topk(worst, 6)
            print("%s floor 2^%d: worst rows (row, error / limit) %s; row 0 "
                  "|dQ| kernel %.3e, plain %.3e; tensor RMS %.6f"
                  % (str(dtype)[6:], round(torch.log2(torch.tensor(floor))
                                          .item()),
                     [(int(i) % s, round(float(x), 3))
                      for x, i in zip(top.values, top.indices)],
                     float(got[:, :, 0].abs().max()),
                     float(want[:, :, 0].abs().max()), rms_t))
    return 0


if __name__ == "__main__":
    sys.exit(main())
