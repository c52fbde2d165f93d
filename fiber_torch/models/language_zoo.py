"""The RNN language encoder (LSTM or GRU, one or both directions).

The PyTorch counterpart of `fiber_tpu/models/language_zoo.py`: embedding,
input dropout, a linear to `word_vec_size` and a ReLU, then `n_layers`
recurrences, each direction over the whole padded sequence as flax's
masked `nn.RNN` runs it: the forward direction reads every position (the
padded ones after the last real token), the backward one reads each row's
real tokens reversed and then its padding reversed, and writes its states
back in the original order.  Returns the per-token states, the masked
mean ("aggregate") and the state at each row's last real token
("final_output").

The weights are `torch.nn.LSTM` / `GRU`'s (`rnn.weight_ih_l{k}[_reverse]`,
gates i f g o, or r z n), the reference's names; `utils/convert.py` maps
flax's per-gate cells onto them.  The steps run as a loop over positions
(`torch.lstm_cell` / `gru_cell`).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from fiber_torch.models.layers import Dropout


def flip_sequences(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """flax's `flip_sequences` on (B, T, ...): position t of row b takes
    (T - 1 - t + lengths[b]) mod T, so the real tokens come reversed and
    then the padding, reversed too."""
    T = x.shape[1]
    t = torch.arange(T - 1, -1, -1, device=x.device)
    idx = (t[None, :] + lengths[:, None]) % T                   # (B, T)
    idx = idx.reshape(idx.shape + (1,) * (x.ndim - 2)).expand_as(x)
    return torch.gather(x, 1, idx)


class RNNLanguageEncoder(nn.Module):
    def __init__(self, vocab_size: int, word_embedding_size: int = 300,
                 word_vec_size: int = 300, hidden_size: int = 512,
                 n_layers: int = 1, rnn_type: str = "lstm",
                 bidirectional: bool = True, input_dropout: float = 0.1):
        super().__init__()
        self.rnn_type = rnn_type.lower()
        if self.rnn_type not in ("lstm", "gru"):
            raise ValueError(f"rnn_type must be lstm or gru, got {rnn_type!r}")
        self.n_layers, self.bidirectional = n_layers, bidirectional
        self.embedding = nn.Embedding(vocab_size, word_embedding_size)
        self.input_dropout = Dropout(input_dropout)
        self.mlp = nn.Sequential(nn.Linear(word_embedding_size,
                                           word_vec_size), nn.ReLU())
        rnn = nn.LSTM if self.rnn_type == "lstm" else nn.GRU
        self.rnn = rnn(word_vec_size, hidden_size, n_layers, batch_first=True,
                       bidirectional=bidirectional)

    def _direction(self, x: torch.Tensor, layer: int, suffix: str
                   ) -> torch.Tensor:
        """One direction of one layer over (B, T, in): the states (B, T, H)
        from a zero start."""
        r = self.rnn
        w_ih = getattr(r, f"weight_ih_l{layer}{suffix}")
        w_hh = getattr(r, f"weight_hh_l{layer}{suffix}")
        b_ih = getattr(r, f"bias_ih_l{layer}{suffix}")
        b_hh = getattr(r, f"bias_hh_l{layer}{suffix}")
        B, T = x.shape[:2]
        h = x.new_zeros(B, r.hidden_size)
        c = x.new_zeros(B, r.hidden_size)
        outs = []
        for t in range(T):
            if self.rnn_type == "lstm":
                h, c = torch.lstm_cell(x[:, t], (h, c), w_ih, w_hh, b_ih, b_hh)
            else:
                h = torch.gru_cell(x[:, t], h, w_ih, w_hh, b_ih, b_hh)
            outs.append(h)
        return torch.stack(outs, dim=1)

    def forward(self, input_ids: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        if mask is None:
            mask = (input_ids != 0).int()
        lengths = mask.sum(dim=1).long()
        x = self.input_dropout(self.embedding(input_ids))
        embedded = self.mlp(x)
        h = embedded
        for layer in range(self.n_layers):
            fwd = self._direction(h, layer, "")
            if self.bidirectional:
                bwd = self._direction(flip_sequences(h, lengths), layer,
                                      "_reverse")
                h = torch.cat([fwd, flip_sequences(bwd, lengths)], dim=-1)
            else:
                h = fwd
        maskf = mask.float()[..., None]
        aggregate = (h * maskf).sum(1) / maskf.sum(1).clamp_min(1.0)
        idx = (lengths - 1).clamp_min(0)
        final = h[torch.arange(h.shape[0], device=h.device), idx]
        return {"hidden": h, "embedded": embedded, "aggregate": aggregate,
                "final_output": final, "masks": mask}
