"""End-to-end DSR: synthesize a corpus, train phone GMM-HMMs, build a
bigram HCLG, then beamform and decode noisy 8-channel eval audio and
report the WER (configs 1 and 4 at small scale).

Counterpart of `examples/end_to_end_asr.py`.

    python -m dsr_tpu_torch.examples.end_to_end_asr
"""

from __future__ import annotations

import numpy as np
import torch

from dsr_tpu_torch.asr import phone_task
from dsr_tpu_torch.asr.am import gmm
from dsr_tpu_torch.asr.decoder import wfst_decoder as wd
from dsr_tpu_torch.asr.fsm import hclg, lm
from dsr_tpu_torch.asr.fsm.packed import pack
from dsr_tpu_torch.asr.train import trainer
from dsr_tpu_torch.config import ArrayGeometry, BeamformerConfig, FilterbankConfig
from dsr_tpu_torch.ops import features as ft
from dsr_tpu_torch.pipeline import DsrPipeline
from dsr_tpu_torch.utils import corpus, room
from dsr_tpu_torch.utils.device import resolve
from dsr_tpu_torch.utils.metrics import RtfMeter, WerScorer

SR = 16000.0


def main(device=None) -> dict:
    dev = resolve(device)

    def feats_of(x):
        x = torch.as_tensor(x, dtype=torch.float32, device=dev)
        return ft.cmn(ft.mfcc(x, SR)).cpu().numpy()

    print("1) synthesizing training corpus + training phone GMM-HMMs ...")
    task = phone_task.PhoneTask(corpus.VOCAB, states_per_phone=2)
    train_corpus = corpus.make_corpus(60, seed=0)
    feats = [feats_of(x) for _, x in train_corpus]
    transcripts = [ws for ws, _ in train_corpus]
    params = trainer.train(task, feats, transcripts, num_comp=2, iters=4, verbose=True,
                           device=dev)

    print("2) building bigram HCLG ...")
    arpa = lm.train_arpa_bigram(transcripts, task.vocab)
    G = lm.arpa_to_fst(arpa, task.words)
    L, ndis = hclg.build_lexicon_fst(task.lexicon, task.phones, task.words, sil_phone="sil")
    H = hclg.build_hmm_fst(len(task.phones) - 1, ndis, states_per_phone=task.spp)
    packed = pack(hclg.compose_hclg(H, L, G, len(task.phones) - 1, ndis))
    graph = wd.to_device(packed, dev)
    print(f"   HCLG: {packed.num_states} states, {packed.num_arcs} arcs")

    print("3) beamforming + decoding noisy 8-channel eval ...")
    pipe = DsrPipeline(fb=FilterbankConfig(M=256, m=4, r=2),
                       geometry=ArrayGeometry.linear(8, 0.04),
                       beamformer=BeamformerConfig(kind="mvdr"), device=dev)
    POS = np.asarray(pipe.geometry.positions)
    pos = np.array([0.4, 1.8, 0.2])
    rng = np.random.default_rng(7)
    sc = WerScorer()
    rtf = RtfMeter()
    for ref, x in corpus.make_corpus(8, seed=123):
        xm = room.simulate(x, POS, pos, SR, snr_db=10.0, rng=rng).astype(np.float32)
        rtf.start()
        y, _ = pipe.process(xm, pos)
        ll = gmm.loglik(params, torch.as_tensor(feats_of(y), device=dev))
        olabs, _, _ = wd.decode(graph, ll)
        rtf.stop(len(x) / SR)
        hyp = wd.words_from_olabels(olabs, task.words)
        sc.add(ref, hyp)
        print(f"   ref: {' '.join(ref):40s}  hyp: {' '.join(hyp)}")
    print(f"4) {sc}   |  {rtf.audio_sec_per_sec:.1f} audio-sec/s")
    return {"wer": sc.wer, "audio_sec_per_sec": rtf.audio_sec_per_sec}


if __name__ == "__main__":
    main()
