#!/usr/bin/env python3
"""Probe of the Transformer serving parity (``chip_smoke.py`` phase 10):
every flash-forward call of the card's decode is held against the plain
version on the same inputs, then the parity is run again with the card's
encoder attention through the plain version. For each form it prints
the rule's verdict, and per step the largest difference between the
devices' top K+1 stage-2 candidate scores of the 8 sentences, up to the
first step where their order differs.

    python3 scripts/flash_parity_probe.py    (GPU)
"""

import os
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402


def main() -> int:
    import torch

    from neuralmonkey_tpu_torch.ops import flash_attention as fa
    from neuralmonkey_tpu_torch.ops import kernel_config
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernel_config.library()
    kernel_forward = fa.flash_forward
    calls = []

    def checked(q, k, v, mask, causal, key_words=None, keep_prob=1.0):
        out, lse = kernel_forward(q, k, v, mask, causal, key_words,
                                  keep_prob)
        if q.is_cuda:
            ref, ref_lse = fa.flash_forward_reference(q, k, v, mask, causal,
                                                      key_words, keep_prob)
            calls.append((tuple(q.shape), tuple(k.shape),
                          float((out - ref).abs().max()),
                          float((lse - ref_lse).abs().max()),
                          float(mask.sum(dim=1).min())))
        return out, lse

    def plain(q, k, v, mask, causal, key_words=None, keep_prob=1.0):
        return fa.flash_forward_reference(q, k, v, mask, causal, key_words,
                                          keep_prob)

    from neuralmonkey_tpu_torch.models.decoders import \
        beam_search_decoder as bsd
    plain_topk = bsd.small_topk
    tops = []

    def recording_topk(x, k):
        if x.shape[1] == k * bsd.LANE:  # stage 2: the exact candidates
            top = torch.sort(x, dim=1, descending=True)
            tops.append((x.device.type, top.values[:, :k + 1].cpu(),
                         top.indices[:, :k + 1].cpu()))
        return plain_topk(x, k)
    bsd.small_topk = recording_topk

    with tempfile.TemporaryDirectory() as tmp:
        cs.write_inputs(tmp)
        _, _, exp, ini, data_ini, ckpt = cs.run_transformer_serving(tmp)
        os.environ["NM_LINEAGE_KERNEL"] = "1"
        for label, forward in (("kernel", checked), ("plain on card", plain)):
            fa.flash_forward = forward
            calls.clear()
            tops.clear()
            try:
                report = cs.check_parity(ini, data_ini, exp, ckpt)
                print(label, "parity passed", report)
            except AssertionError as err:
                print(label, "parity failed:", err)
            cpu = [t for t in tops if t[0] == "cpu"]
            gpu = [t for t in tops if t[0] == "cuda"]
            torch.set_printoptions(precision=6, linewidth=200)
            for step, (c, g) in enumerate(zip(cpu, gpu)):
                drift = float((c[1][:8] - g[1][:8]).abs().max())
                same = bool(torch.equal(c[2][:8], g[2][:8]))
                print(label, "step", step, "max |cpu - card| of the top "
                      "K+1 scores", drift, "same indices", same)
                if not same:
                    for row in range(8):
                        if not torch.equal(c[2][row], g[2][row]):
                            print(label, "row", row, "cpu", c[1][row],
                                  c[2][row], "card", g[1][row], g[2][row])
                    break
            for call in calls:
                print(label, "flash call q, k, max |out - plain|, max |lse - "
                      "plain|, fewest valid keys:", call)
    return 0


if __name__ == "__main__":
    sys.exit(main())
