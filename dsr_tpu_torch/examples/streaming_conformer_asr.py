"""Streaming Conformer-CTC ASR: train a small chunk-causal Conformer-CTC on
the synthetic small-vocabulary corpus, then recognise a multi-channel
reverberant utterance INCREMENTALLY: audio chunks → MVDR beamformed
subbands → features → streaming Conformer steps → words printed as they
are emitted (the CTC analogue of `streaming_asr`'s WFST path).

Counterpart of `examples/streaming_conformer_asr.py`, trained with
`torch.optim.Adam` and `clip_grad_norm_` (global norm 1.0); the batch
goes through the model under `torch.func.vmap`.  `STEPS` (environment,
default 1500) caps the training steps; training stops once the CTC loss
is below 0.05.  Unlike the JAX example, which trains on the 50 clean
utterances alone, the training set adds two renderings of each through
the streamed utterance's room and MVDR front end.

    python -m dsr_tpu_torch.examples.streaming_conformer_asr
"""

from __future__ import annotations

import os

import numpy as np
import torch

from dsr_tpu_torch.config import ArrayGeometry, BeamformerConfig, FilterbankConfig
from dsr_tpu_torch.models.conformer import ctc_loss
from dsr_tpu_torch.models.streaming_conformer import StreamingConformerCtc
from dsr_tpu_torch.ops import features as ft
from dsr_tpu_torch.ops import filterbank as fb
from dsr_tpu_torch.pipeline import DsrPipeline, StreamingCtcRecognizer
from dsr_tpu_torch.utils import corpus, room
from dsr_tpu_torch.utils.device import resolve

SR = 16000.0


def main(device=None) -> dict:
    dev = resolve(device)
    vocab = corpus.VOCAB
    widx = {w: i + 1 for i, w in enumerate(vocab)}

    # ---- the array, the room and the talker of the streamed utterance ----
    fbcfg = FilterbankConfig(M=64, m=4, r=2)
    pipe = DsrPipeline(fb=fbcfg, geometry=ArrayGeometry.circular(6, 0.10),
                       beamformer=BeamformerConfig(kind="mvdr"), device=dev)
    POS = np.asarray(pipe.geometry.positions)
    srcpos = np.array([0.6, 1.5, 0.3])

    def render(x, rng):
        return room.simulate(x, POS, srcpos, SR, snr_db=25.0, rng=rng,
                             room_dim=np.array([5.0, 4.0, 3.0]),
                             array_center=np.array([2.0, 1.0, 1.2]),
                             reflect=0.3, max_order=1).astype(np.float32)

    def feats_of(x):
        A = fb.analysis(torch.as_tensor(np.asarray(x, np.float32), device=dev), fbcfg)
        return ft.mfcc_from_subbands(A, fbcfg.M, SR).cpu().numpy()

    def mvdr_feats_of(xm):
        A = fb.analysis(torch.as_tensor(xm, device=dev), fbcfg)
        return ft.mfcc_from_subbands(pipe.beamform_subbands(A, srcpos)[0], fbcfg.M, SR).cpu().numpy()

    # ---- train on clean single-channel features and on the same utterances
    # rendered twice in the room through the array's MVDR (multi-condition:
    # the superdirective MVDR's features differ from a single microphone's
    # by 0.2-0.8 of a feature's spread, and a model trained on clean
    # features alone recognised the streamed utterance for only some
    # initialisations and float orders of its training)
    model = StreamingConformerCtc(len(vocab), dim=48, layers=2, heads=2, chunk=8, left=2,
                                  feat_dim=13, device=dev,
                                  generator=torch.Generator().manual_seed(0))
    clean = corpus.make_corpus(50, min_words=1, max_words=2, seed=0)
    rngr = np.random.default_rng(11)
    feats = [feats_of(x) for _, x in clean]
    fcat = np.concatenate(feats[:10])
    gmean = np.mean(fcat, axis=0)
    gstd = np.std(fcat, axis=0) + 1e-3     # global feature normalisation
    feats += [mvdr_feats_of(render(x, rngr)) for _ in range(2) for _, x in clean]
    data = clean * 3
    T = max(f.shape[0] for f in feats)
    T = ((T + 31) // 32) * 32
    # noise padding: exact-zero rows make the zero-variance LayerNorm
    # Jacobians explode through the depth
    rngp = np.random.default_rng(99)
    F = rngp.standard_normal((len(data), T, 13)).astype(np.float32) * 0.01
    lab = np.zeros((len(data), 2), np.int64)
    lens = np.zeros(len(data), np.int64)
    flens = np.zeros(len(data), np.int64)    # valid subsampled frames
    for i, ((ws, _), f) in enumerate(zip(data, feats)):
        F[i, :f.shape[0]] = (f - gmean) / gstd
        flens[i] = (f.shape[0] - 7) // 4 + 1
        ids = [widx[w] for w in ws]
        lab[i, :len(ids)] = ids
        lens[i] = len(ids)

    opt = torch.optim.Adam(model.parameters(), lr=3e-3)
    batched = torch.func.vmap(model)
    Ft = torch.as_tensor(F, device=dev)
    for s in range(int(os.environ.get("STEPS", "1500"))):
        opt.zero_grad()
        loss = ctc_loss(batched(Ft), flens, lab, lens)
        loss.backward()
        torch.nn.utils.clip_grad_norm_(model.parameters(), 1.0)
        opt.step()
        loss = float(loss.detach())
        if s % 100 == 0:
            print(f"train step {s}: ctc loss {loss:.3f}", flush=True)
        if loss < 0.05:
            print(f"converged at step {s}: ctc loss {loss:.3f}")
            break

    # ---- stream a reverberant multi-channel utterance -------------------
    ws, x = corpus.make_corpus(1, min_words=2, max_words=2, seed=123)[0]
    xm = render(x, np.random.default_rng(5))

    rec = StreamingCtcRecognizer(pipe, model, srcpos, cep_mean=gmean, cep_scale=gstd)
    B = 4000
    chunks = [xm[:, i:i + B] for i in range(0, xm.shape[-1], B)]
    print(f"reference: {ws}")
    for out in rec.run(iter(chunks)):
        t_audio = rec.state.pos * 4 * fbcfg.D / SR
        print(f"  t={t_audio:5.2f}s  partial: {[vocab[i - 1] for i in out]}", flush=True)
    hyp = [vocab[i - 1] for i in rec.finish()]
    print(f"final: {hyp}")
    assert hyp == list(ws), (hyp, ws)
    print("streaming transcript matches the reference words")
    return {"hyp": hyp, "reference": list(ws), "steps": s + 1, "loss": loss}


if __name__ == "__main__":
    main()
