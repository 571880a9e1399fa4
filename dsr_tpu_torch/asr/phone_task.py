"""Phone-level HMM task for the synthetic corpus (the port's copy of
`dsr_tpu/asr/phone_task.py`): alignment graphs over pdf ids that match the
H transducer's pdf numbering (`asr/fsm/hclg.build_hmm_fst`), so GMMs
trained here drop straight into HCLG decoding."""

from __future__ import annotations

import numpy as np

from dsr_tpu_torch.asr.fsm.hclg import SymbolTable
from dsr_tpu_torch.utils.corpus import PHONES, WORDS

LOG0 = -1e30


class PhoneTask:
    def __init__(self, vocab: list[str], states_per_phone: int = 2,
                 self_lp: float = float(np.log(0.6))):
        self.vocab = list(vocab)
        self.spp = states_per_phone
        self.self_lp = self_lp
        self.phones = SymbolTable(["sil"] + sorted(PHONES))
        self.words = SymbolTable(self.vocab)
        self.num_pdfs = (len(self.phones) - 1) * states_per_phone
        self.lexicon = {w: WORDS[w] for w in self.vocab}

    @property
    def num_states(self) -> int:  # trainer-facing alias
        return self.num_pdfs

    def pdf(self, phone_name: str, k: int) -> int:
        return (self.phones[phone_name] - 1) * self.spp + k

    def utt_pdf_seq(self, words: list[str]) -> np.ndarray:
        """Linear pdf-state sequence: sil w1 sil w2 ... sil."""
        seq = list(range(self.pdf("sil", 0), self.pdf("sil", 0) + self.spp))
        for w in words:
            for ph in self.lexicon[w]:
                base = self.pdf(ph, 0)
                seq.extend(range(base, base + self.spp))
            seq.extend(range(self.pdf("sil", 0), self.pdf("sil", 0) + self.spp))
        return np.asarray(seq, np.int32)

    def align_graph(self, words: list[str]):
        """→ (ids (L,) pdf per position, logA (L,L), init, final) linear."""
        ids = self.utt_pdf_seq(words)
        L = len(ids)
        A = np.full((L, L), LOG0, np.float32)
        adv = float(np.log1p(-np.exp(self.self_lp)))
        for i in range(L):
            A[i, i] = self.self_lp
            if i + 1 < L:
                A[i, i + 1] = adv
        init = np.full(L, LOG0, np.float32)
        init[0] = 0.0
        final = np.full(L, LOG0, np.float32)
        final[L - 1] = 0.0
        return ids, A, init, final
