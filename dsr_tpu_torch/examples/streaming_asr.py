"""Streaming recognition: multi-channel audio arrives in ragged chunks; the
`StreamingRecognizer` carries front-end, beamformer and decoder state
across them and emits the SAME words as the offline decode.

Counterpart of `examples/streaming_asr.py`: a small phone GMM-HMM and its
bigram HCLG (config 1) trained from the synthetic corpus, an eval
utterance rendered onto a 4-mic array, delay-and-sum, the top-K decoder's
chunked decode.

    python -m dsr_tpu_torch.examples.streaming_asr
"""

from __future__ import annotations

import numpy as np
import torch

from dsr_tpu_torch.asr import phone_task
from dsr_tpu_torch.asr.am import gmm
from dsr_tpu_torch.asr.decoder import topk_decoder as tk
from dsr_tpu_torch.asr.fsm import hclg, lm
from dsr_tpu_torch.asr.fsm.packed import pack
from dsr_tpu_torch.asr.train import trainer
from dsr_tpu_torch.config import ArrayGeometry, BeamformerConfig, FilterbankConfig
from dsr_tpu_torch.ops import features as ft
from dsr_tpu_torch.ops import filterbank as fb
from dsr_tpu_torch.pipeline import DsrPipeline, StreamingRecognizer
from dsr_tpu_torch.utils import corpus, room
from dsr_tpu_torch.utils.device import resolve

SR = 16000.0


def main(device=None) -> dict:
    dev = resolve(device)
    # ---- train a small phone GMM-HMM + bigram HCLG (config 1) -----------
    task = phone_task.PhoneTask(corpus.VOCAB[:6], states_per_phone=2)
    fbc = FilterbankConfig(M=64, m=2, r=2)
    feats, transcripts = [], []
    for ws, x in corpus.make_corpus(30, seed=0):
        ws = [w if w in task.vocab else task.vocab[0] for w in ws]
        A = fb.analysis(torch.as_tensor(np.asarray(x, np.float32), device=dev), fbc)
        feats.append(ft.cmn(ft.mfcc_from_subbands(A, fbc.M, SR)).cpu().numpy())
        transcripts.append(ws)
    params = trainer.train(task, feats, transcripts, num_comp=2, iters=3, device=dev)
    arpa = lm.train_arpa_bigram(transcripts, task.vocab)
    G = lm.arpa_to_fst(arpa, task.words)
    L, ndis = hclg.build_lexicon_fst(task.lexicon, task.phones, task.words, sil_phone="sil")
    H = hclg.build_hmm_fst(len(task.phones) - 1, ndis, states_per_phone=task.spp)
    tg = tk.build_token_graph(pack(hclg.compose_hclg(H, L, G, len(task.phones) - 1, ndis)),
                              device=dev)

    # ---- an eval utterance rendered onto a 4-mic array -------------------
    geom = ArrayGeometry.linear(4, 0.05)
    pipe = DsrPipeline(fb=fbc, geometry=geom, beamformer=BeamformerConfig(kind="ds"),
                       device=dev)
    ref_words, x = corpus.make_corpus(1, min_words=3, max_words=4, seed=42)[0]
    ref_words = [w if w in task.vocab else task.vocab[0] for w in ref_words]
    src_pos = np.array([0.4, 1.2, 0.0])
    xm = room.simulate(np.asarray(x, np.float32), np.asarray(geom.positions), src_pos, SR,
                       snr_db=25.0, rng=np.random.default_rng(7)).astype(np.float32)

    # fixed cepstral mean (streaming CMN is not causal; production systems
    # use a precomputed mean), here from the training data
    cep_mean = np.mean(np.concatenate(feats), axis=0)

    # ---- offline reference ------------------------------------------------
    A = fb.analysis(torch.as_tensor(xm, device=dev), pipe.fb)
    Y, _ = pipe.beamform_subbands(A, src_pos)
    f_off = ft.mfcc_from_subbands(Y, pipe.fb.M, SR) - torch.as_tensor(cep_mean, device=dev)
    olabs, _ = tk.decode(tg, gmm.loglik(params, f_off), kcap=128)
    words_off = [task.words.name(int(w)) for w in olabs.cpu() if w]

    # ---- streamed: ragged chunks through the full chain -------------------
    rng = np.random.default_rng(1)
    cuts = np.sort(rng.choice(np.arange(400, xm.shape[-1] - 400), 6, replace=False))
    bounds = [0, *map(int, cuts), xm.shape[-1]]
    chunks = [xm[:, bounds[i]:bounds[i + 1]] for i in range(len(bounds) - 1)]
    rec = StreamingRecognizer(pipe, lambda f: gmm.loglik(params, f), tg, src_pos, kcap=128,
                              cep_mean=cep_mean)
    word_ids, score = rec.run(chunks)
    words_s = [task.words.name(w) for w in word_ids]

    print(f"reference : {' '.join(ref_words)}")
    print(f"offline   : {' '.join(words_off)}")
    print(f"streamed  : {' '.join(words_s)}  (chunks: {[c.shape[-1] for c in chunks]})")
    assert words_s == words_off, "streamed decode must equal offline"
    print(f"streamed == offline ✓  (score {score:.1f})")
    return {"reference": ref_words, "offline": words_off, "streamed": words_s, "score": score}


if __name__ == "__main__":
    main()
