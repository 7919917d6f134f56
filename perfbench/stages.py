"""The stage-by-stage check: every stage of one step of the program against
the reference run on the program's own input to that stage
(``tap.py`` keeps them). Two numbers come out: the worst stage's
``rel_rms`` (the start, every layer, the final LayerNorm) and the
lm_head's ``row_err``. With ``control`` the float8 reference stands in
for the program's outputs, stage by stage on the same inputs.
"""
from __future__ import annotations

import torch

from perfbench import port
from perfbench.reference import compare, models


def numerics(ref: dict, sites: dict, lower=False) -> models.Numerics:
    return models.Numerics(ref["variant"], sites,
                           flash=ref.get("flash", False), lower=lower)


def _pick(t: torch.Tensor, rows):
    return t if rows is None else t[rows]


class Stages:
    """The readings of one step's stages."""

    def __init__(self, cell, sites: dict, control: bool, rows=None):
        ref = cell.workload["reference"]
        self.num = numerics(ref, sites)
        self.low = numerics(ref, sites, lower=True)
        self.control = control
        self.rows = rows
        self.errs = []
        self.head = 0.0

    def start(self, got, ref) -> None:
        self.errs.append(compare.rel_rms(_pick(got, self.rows),
                                         _pick(ref, self.rows)))

    def layer(self, fn, out) -> None:
        """``fn(numerics)`` recomputes the stage; ``out`` is the program's."""
        ref = fn(self.num)
        got = fn(self.low) if self.control else out
        self.errs.append(compare.rel_rms(_pick(got, self.rows),
                                         _pick(ref, self.rows)))

    def final(self, params, last, head_call) -> None:
        """The final LayerNorm from the last layer's output, and the lm_head
        from the program's normed hidden state."""
        x = head_call["x"]
        self.errs.append(compare.rel_rms(
            _pick(x, self.rows), _pick(models.layer_norm(
                last, params["final_ln_scale"], params["final_ln_bias"]),
                self.rows)))
        ref = self.num.dense("lm_head", x, params["lm_head"])
        got = (self.low.dense("lm_head", x, params["lm_head"])
               if self.control else head_call["out"])
        self.head = max(self.head, compare.row_err(_pick(got, self.rows),
                                                   _pick(ref, self.rows)))

    @property
    def worst(self) -> float:
        return max(self.errs)


@torch.no_grad()
def dense_step(cell, params, blocks, head_call, tokens, sites, *,
               control=False, attention=None, rows=None) -> Stages:
    """One forward of the dense decoder: ``blocks`` its layers' calls in
    order, ``head_call`` the lm_head's; ``attention(call, numerics)``
    gives a layer's attention (default: causal over the sequence)."""
    w = port.widths(cell.config)
    attention = attention or (lambda c, n: models.causal_attention(
        w, c["kw"]["positions"], n))
    st = Stages(cell, sites, control, rows)
    st.start(blocks[0]["x"], params["embedding"][tokens])
    for i, c in enumerate(blocks):
        blk = models.layer(params["blocks"], i)
        st.layer(lambda n, c=c, blk=blk: models.decoder_layer(
            blk, c["x"], n, w["head_dim"], attention(c, n)), c["out"])
    st.final(params, blocks[-1]["out"], head_call)
    return st


@torch.no_grad()
def whisper_step(cell, params, frames, enc_calls, dec_calls, head_call,
                 tokens, *, control=False) -> Stages:
    """The encoder pass of set-up and one decode step: the encoder's start
    and layers, the decoder's start and layers (each from the program's
    slot cache as it stood before the step, and the program's encoder
    states), the final LayerNorm and the lm_head."""
    w = port.widths(cell.config)
    hd = w["head_dim"]
    st = Stages(cell, cell.workload["reference"]["sites"], control)
    st.start(enc_calls[0]["x"],
             frames.to(torch.bfloat16) + params["enc_pos"].to(torch.bfloat16))
    for i, c in enumerate(enc_calls):
        blk = models.layer(params["enc_blocks"], i)
        st.layer(lambda n, c=c, blk=blk: models.encoder_layer(
            blk, c["x"], n, hd), c["out"])
    st.start(dec_calls[0]["x"], params["embedding"][tokens])
    for i, c in enumerate(dec_calls):
        blk = models.layer(params["dec_blocks"], i)
        pos = int(c["kw"]["cache"]["pos"])
        attention = models.slot_attention(pos, c["before"]["k"],
                                          c["before"]["v"])
        st.layer(lambda n, c=c, blk=blk, a=attention: models.encdec_layer(
            blk, c["x"], c["kw"]["enc_kv"], n, hd, a), c["out"])
    st.final(params, dec_calls[-1]["out"], head_call)
    return st
