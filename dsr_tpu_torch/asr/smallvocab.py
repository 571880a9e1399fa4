"""Small-vocabulary whole-word HMM task: state maps + dense decode graphs.

The port's copy of `dsr_tpu/asr/smallvocab.py` (numpy, build time): BASELINE
config 1's "small GMM-HMM Viterbi decode"; the WFST stack
(`dsr_tpu_torch/asr/fsm`) is the large-vocabulary path.

Topology: 1-state silence + per-word left-to-right chains
(states_per_phone × len(phones)).  Decode graph is a word loop:
sil → word starts, word end → sil, init/final in sil.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from dsr_tpu_torch.utils.corpus import WORDS

LOG0 = -1e30


@dataclass
class SmallVocabTask:
    vocab: list[str]
    states_per_phone: int = 2
    self_lp: float = float(np.log(0.6))
    sil_self_lp: float = float(np.log(0.7))
    word_starts: dict = field(default_factory=dict)
    num_states: int = 0
    state_word: np.ndarray | None = None  # state → vocab index (-1 = sil)

    def __post_init__(self):
        # state 0 = silence; then each word's chain
        self.word_starts = {}
        s = 1
        for w in self.vocab:
            self.word_starts[w] = s
            s += self.states_per_phone * len(WORDS[w])
        self.num_states = s
        sw = np.full(s, -1, np.int32)
        for i, w in enumerate(self.vocab):
            st = self.word_starts[w]
            sw[st : st + self.states_per_phone * len(WORDS[w])] = i
        self.state_word = sw

    def word_len(self, w: str) -> int:
        return self.states_per_phone * len(WORDS[w])

    def decode_graph(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """→ (logA (S,S), init (S,), final (S,)) dense word-loop graph."""
        S = self.num_states
        A = np.full((S, S), LOG0)
        adv = np.log1p(-np.exp(self.self_lp))
        sil_exit = np.log1p(-np.exp(self.sil_self_lp))
        A[0, 0] = self.sil_self_lp
        lp_word = sil_exit - np.log(len(self.vocab))
        for w in self.vocab:
            st, n = self.word_starts[w], self.word_len(w)
            A[0, st] = lp_word
            for i in range(n):
                A[st + i, st + i] = self.self_lp
                if i + 1 < n:
                    A[st + i, st + i + 1] = adv
            A[st + n - 1, 0] = adv  # word end → silence
        init = np.full(S, LOG0)
        init[0] = 0.0
        final = np.full(S, LOG0)
        final[0] = 0.0
        for w in self.vocab:
            final[self.word_starts[w] + self.word_len(w) - 1] = 0.0
        return A, init, final

    def align_graph(self, words: list[str]) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Linear forced-alignment graph sil w1 sil w2 ... sil.

        → (state_ids (L,) global state per graph position, logA (L,L),
           init (L,), final (L,))
        """
        ids = [0]
        for w in words:
            st = self.word_starts[w]
            ids.extend(range(st, st + self.word_len(w)))
            ids.append(0)
        ids = np.asarray(ids, np.int32)
        L = len(ids)
        A = np.full((L, L), LOG0)
        adv = np.log1p(-np.exp(self.self_lp))
        sil_exit = np.log1p(-np.exp(self.sil_self_lp))
        for i in range(L):
            is_sil = ids[i] == 0
            A[i, i] = self.sil_self_lp if is_sil else self.self_lp
            if i + 1 < L:
                A[i, i + 1] = sil_exit if is_sil else adv
        init = np.full(L, LOG0)
        init[0] = 0.0
        final = np.full(L, LOG0)
        final[L - 1] = 0.0
        return ids, A, init, final

    def path_to_words(self, path: np.ndarray) -> list[str]:
        """Collapse a decoded state path to the word sequence.

        Word chains are left-to-right (no back arcs), so each word instance
        enters its start state exactly once: emit on every transition INTO a
        word-start state.
        """
        starts = {self.word_starts[w]: w for w in self.vocab}
        words = []
        prev = -1
        for s in path:
            s = int(s)
            if s != prev and s in starts:
                words.append(starts[s])
            prev = s
        return words
