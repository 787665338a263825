"""The output check that decides ``correct``: what the timed path served,
judged by the configuration's plain reference, which makes its weights and
inputs again from the seed and computes in float32.

Conversions (``serve_batch``, ``convert``): for a sample of the window's
requests drawn from the seed, the reference converts each source again
(audio, speaker embeddings, generator, vocoder conditioning) and runs the
vocoder teacher-forced over the fold rows the program's sampling loop
served, with the same noise drawn again from the request's seed and
rounded to the configuration's precision, as the program takes it.  Three
numbers:

* ``mel_err``: the widest gap between the converted mel the program
  handed its vocoder and the reference's, over every frame and bin;
* ``served_gap``: the widest distance, in noise units, from a served
  sample to one the reference would serve at that step
  (``pick_costs``: a pick's shortfall below the best Gumbel-perturbed
  score, plus for MOL the shift of its logistic noise the value needs),
  over every sample that reaches the output;
* ``finish_err``: the widest gap between the served waveform and the
  reference's finish of the served rows (crossfade, trim, fade, PCM16,
  outprocessing), in full-scale units.

Training (``train_ae``): the reference takes the same first steps from the
same weights and batches, and :func:`compare_training` reads the gaps of
the steps' losses, of each leaf's first gradient norm as the optimizer got
it, of its change over the steps and of its EMA's change; a leaf's gap is
over the larger of its reference norm and the median leaf's, and leaves
whose reference gradient is under a thousandth of the median leaf's are
left out.  The cell's limits file names the ones compared.
"""
from __future__ import annotations

import numpy as np
import torch

from h100bench import weights

BLOCK_ROWS = 16


def judge(cell, seed: int, items: list, device,
          control: bool = False) -> tuple:
    """({number: {"value", "limit"}} of the cell's output check; with
    ``control``, {control: {number: value}} of each fp8 control's readings
    of the same numbers (else empty); and what the check looked at:
    positions judged, or the worst leaf of each training number)."""
    controls = {}
    if cell.kind == "train_ae":
        values = judge_training(cell, seed, items[0], device)
        if control:
            controls["fp8"] = compare_training(reference_record(
                cell, seed, device, "fp8"), values["ref"])
            controls["fp8"].pop("worst", None)
        detail = {k: v for k, v in values.items() if k != "ref"}
    else:
        values = judge_conversions(cell, seed, items, device, control)
        for key, v in values.items():
            if "/" in key:
                name, number = key.split("/")
                controls.setdefault(name, {})[number] = v
        detail = {"positions": values["positions"]}
    checks = {k: {"value": float(values[k]), "limit": float(cell.limits[k])}
              for k in cell.limits}
    controls = {n: {k: float(v) for k, v in c.items()}
                for n, c in controls.items()}
    return checks, controls, detail


def passes(readings: dict, limits: dict) -> bool:
    """Whether ``readings`` ({number: value}) keep within ``limits``, by
    the rule that decides ``correct``: every number that has a limit at or
    under it.  A reading with no number under a limit passes nothing."""
    judged = [k for k in readings if k in limits]
    return bool(judged) and all(readings[k] <= limits[k] for k in judged)


def sample_items(cell, seed: int, items: list) -> list:
    """The judged requests: drawn from the seed, the longest among them."""
    n = cell.mix.get("judged_calls", cell.mix.get("judged_requests", 1))
    rng = np.random.default_rng(weights.stream_seed(seed, "judged"))
    longest = max(range(len(items)), key=lambda i: sum(
        s for _, s in items[i]["sources"]))
    pick = set(rng.choice(len(items), size=min(n, len(items)),
                          replace=False).tolist())
    if longest not in pick:
        pick.discard(min(pick))
        pick.add(longest)
    return [items[i] for i in sorted(pick)]


def reference_models(cell, seed: int, device, precision: str) -> dict:
    from h100bench.harness import make_states
    ref = cell.reference()
    ref.exact_f32()
    states = make_states(ref, cell.config, seed, device)
    groups = {"speaker_encoder": "speaker_encoder",
              "generator": "auto_encoder", "vocoder": "vocoder"}
    return {k: ref.build(k, cell.config[g], precision, device, states[k])
            for k, g in groups.items()}


@torch.no_grad()
def judge_conversions(cell, seed: int, items: list, device,
                      control: bool = False) -> dict:
    """``mel_err``, ``served_gap`` and ``finish_err`` over the judged
    requests; with ``control``, also each control's readings of the same
    numbers under ``<control>/<number>`` (:data:`CONTROLS`)."""
    ref = cell.reference()
    cfg = cell.config
    models = reference_models(cell, seed, device, "f32")
    ctrl = reference_models(cell, seed, device, "fp8") if control else None
    out = {"served_gap": 0.0, "finish_err": 0.0, "mel_err": 0.0,
           "positions": 0}
    for item in sample_items(cell, seed, items):
        r = judge_request(ref, cfg, models, ctrl, item, device)
        for k, v in r.items():
            out[k] = out.get(k, 0) + v if k == "positions" else max(
                out.get(k, 0.0), v)
    return out


# The controls of a conversion, each the reference put in the program's
# place one precision below the configuration's: "fp8", the whole chain
# (speaker encoder, generator, vocoder) with fp8 weights and layer inputs;
# "fp8_vocoder", the vocoder alone so, on the float32 chain's mel.  Both
# take the noise at the configuration's precision, as the program does.
CONTROLS = ("fp8", "fp8_vocoder")


def _folded(ref, voc_model, post, voc: dict, steps: int) -> tuple:
    """(cond rows (n, steps, feat), aux rows (n, steps, res)) of the mel
    ``post`` through ``voc_model``'s conditioning, folded as served."""
    overlap = voc["generate"]["overlap"]
    mels, aux = ref.conditioning(voc_model, post, voc)
    target = steps - 2 * overlap
    return ref.fold(mels, target, overlap), ref.fold(aux, target, overlap)


def _conditioned_rows(ref, cfg, m, item, device, steps):
    """Per source: (cond rows (n, steps, feat), aux rows (n, steps, res),
    wave_len) of the reference models ``m``."""
    sr = cfg["auto_encoder"]["spectrogram"]["sr"]
    se_c = cfg["speaker_encoder"]["spectrogram"]
    target_db = cfg["convert"]["preprocess_args"]["target_dBFS"]
    voc = cfg["vocoder"]
    t_wav = ref.normalize_volume(ref.load_wav(item["target"], sr), target_db)
    c_trg = ref.embed(m["speaker_encoder"], t_wav, sr, se_c, device)
    rows = []
    for path, _ in item["sources"]:
        wav = ref.normalize_volume(ref.load_wav(path, sr), target_db)
        c_org = ref.embed(m["speaker_encoder"], wav, sr, se_c, device)
        post = ref.generator_mel(m["generator"], wav, c_org[None],
                                 c_trg[None], cfg["auto_encoder"], device)
        wave_len = (post.shape[-1] - 1) * voc["hop_length"]
        rows.append(_folded(ref, m["vocoder"], post, voc, steps)
                    + (wave_len, post))
    return rows


def judge_request(ref, cfg, models, ctrl, item, device) -> dict:
    precision = cfg["precision"]
    voc = cfg["vocoder"]
    mode = voc["mode"]
    n_cls = ref.n_classes(voc)
    lanes = n_cls if mode == "RAW" else n_cls // 3
    overlap = voc["generate"]["overlap"]
    steps = int(item["launches"][0].shape[1])
    target = steps - 2 * overlap
    rows = _conditioned_rows(ref, cfg, models, item, device, steps)
    out = {"served_gap": 0.0, "finish_err": 0.0, "positions": 0,
           "mel_err": max(float((m.reshape(r[3].shape).float() - r[3])
                                .abs().max())
                          for m, r in zip(item["mels"], rows))}
    # each control's fold rows of conditioning, per source
    cond = {}
    if ctrl is not None:
        crows = _conditioned_rows(ref, cfg, ctrl, item, device, steps)
        cond["fp8"] = [c[:2] for c in crows]
        cond["fp8_vocoder"] = [_folded(ref, ctrl["vocoder"], r[3], voc, steps)
                               for r in rows]
        out["fp8/mel_err"] = max(float((c[3] - r[3]).abs().max())
                                 for c, r in zip(crows, rows))
        for name in CONTROLS:
            out[f"{name}/served_gap"] = 0.0
    # (utterance, fold) of each served row, in the program's row order
    owner = [(u, i) for u, r in enumerate(rows)
             for i in range(r[0].shape[0])]
    served = torch.cat([t.float() for t in item["launches"]])[:len(owner)]
    gen = torch.Generator(device=device).manual_seed(item["seed"])
    r0 = 0
    for launch in item["launches"]:
        B = int(launch.shape[0])
        if int(launch.shape[1]) != steps:
            raise ValueError("sampling launches of one request differ in "
                             "their steps")
        gumbel, logistic = ref.draw_noise(gen, steps, B, lanes, device)
        # the noise at the configuration's precision, as every side takes it
        gumbel, logistic = (ref.round_to(gumbel, precision),
                            ref.round_to(logistic, precision))
        for b0 in range(r0, min(r0 + B, len(owner)), BLOCK_ROWS):
            b1 = min(b0 + BLOCK_ROWS, r0 + B, len(owner))
            sl = slice(b0 - r0, b1 - r0)
            g = gumbel[:, sl].transpose(0, 1)
            lg = logistic[:, sl].transpose(0, 1)
            s = served[b0:b1]
            x_prev = torch.nn.functional.pad(s[:, :-1], (1, 0))
            mask = torch.stack([
                torch.arange(steps, device=device) + i * (target + overlap)
                < rows[u][2] for u, i in owner[b0:b1]])
            mels = torch.stack([rows[u][0][i] for u, i in owner[b0:b1]])
            aux = torch.stack([rows[u][1][i] for u, i in owner[b0:b1]])
            logits = models["vocoder"].sample_rate_pass(x_prev, mels, aux)
            cost = ref.pick_costs(logits, g, lg, s, mode, n_cls)
            out["served_gap"] = max(out["served_gap"],
                                    float(cost[mask].max()))
            out["positions"] += int(mask.sum())
            for name, c in cond.items():
                cm = torch.stack([c[u][0][i] for u, i in owner[b0:b1]])
                ca = torch.stack([c[u][1][i] for u, i in owner[b0:b1]])
                cl = ctrl["vocoder"].sample_rate_pass(x_prev, cm, ca)
                cs = ref.control_samples(cl, g, lg, mode, n_cls)
                cc = ref.pick_costs(logits, g, lg, cs, mode, n_cls)
                key = f"{name}/served_gap"
                out[key] = max(out[key], float(cc[mask].max()))
        r0 += B
    mu_law = n_cls if (mode == "RAW" and voc["generate"]["mu_law"]) else None
    post = {"target_dBFS": cfg["convert"]["outprocess_args"]["target_dBFS"],
            "remove_noise": "remove_noise" in cfg["convert"]["outprocess"],
            "sr": cfg["convert"]["sr"]}
    served_np = served.cpu().numpy()
    row = 0
    for u, (c, _, wave_len, _) in enumerate(rows):
        n = c.shape[0]
        want = ref.finish(served_np[row:row + n], overlap, wave_len,
                          voc["hop_length"], mu_law, post)
        got = np.asarray(item["outputs"][u], np.float32)
        err = (float(np.abs(got - want).max()) if got.shape == want.shape
               else float("inf"))
        out["finish_err"] = max(out["finish_err"], err)
        row += n
    return out


def _leaf_gaps(prog: dict, refv: dict, keep) -> list:
    """(|prog - ref| / max(ref, median ref), leaf) of each kept leaf,
    widest first."""
    names = [n for n in refv if keep(n)]
    med = float(np.median([refv[n] for n in names]))
    return sorted(((abs(prog[n] - refv[n]) / max(refv[n], med), n)
                   for n in names), reverse=True)


def reference_record(cell, seed: int, device, precision: str = "f32"):
    """The reference's first steps from the seed's weights and batches:
    each step's loss, each leaf's first clipped gradient norm, its change
    and its EMA's change over the steps (the program's record's keys)."""
    from h100bench import traffic
    from h100bench.harness import make_states
    ref = cell.reference()
    ref.exact_f32()
    cfg, mix = cell.config, cell.mix
    ae = cfg["auto_encoder"]
    state = make_states(ref, cfg, seed, device, ("generator",))["generator"]
    gen = ref.build("generator", ae, precision, device, state).train()
    params = dict(gen.named_parameters())
    p0 = {n: p.detach().clone() for n, p in params.items()}
    mels, embs = traffic.train_pool(mix, seed, ae["n_mels"], ae["dim_emb"],
                                    device)
    batches = traffic.train_batches(mix, seed, mix["reference_steps"])
    oc = ae["optimizer"]
    b1, b2 = oc["betas"]
    decay = ae["learn"]["ema_decay"]
    mu = {n: torch.zeros_like(p) for n, p in params.items()}
    nu = {n: torch.zeros_like(p) for n, p in params.items()}
    ema = {n: p.clone() for n, p in p0.items()}
    rec = {"loss": [], "grad_norm": {}}
    for k, idx in enumerate(batches):
        idx = torch.as_tensor(idx, device=device)
        gen.zero_grad(set_to_none=True)
        loss = gen.loss(mels[idx], embs[idx])
        loss.backward()
        rec["loss"].append(float(loss.detach()))
        with torch.no_grad():
            grads = {n: p.grad for n, p in params.items()}
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
            if float(norm) >= oc["grad_clip_norm"]:
                grads = {n: g / norm * oc["grad_clip_norm"]
                         for n, g in grads.items()}
            if k == 0:
                rec["grad_norm"] = {n: float(torch.linalg.norm(g))
                                    for n, g in grads.items()}
                rec["grad"] = {n: g.detach().clone()
                               for n, g in grads.items()}
            for n, p in params.items():
                mu[n].mul_(b1).add_((1 - b1) * grads[n])
                nu[n].mul_(b2).add_((1 - b2) * grads[n] * grads[n])
                u = (mu[n] / (1 - b1 ** (k + 1))) / (
                    torch.sqrt(nu[n] / (1 - b2 ** (k + 1))) + oc["eps"])
                p.add_(-oc["lr"] * u)
                ema[n].mul_(decay).add_((1 - decay) * p)
    rec["change"] = {n: float(torch.linalg.norm(p.detach() - p0[n]))
                     for n, p in params.items()}
    rec["ema_change"] = {n: float(torch.linalg.norm(ema[n] - p0[n]))
                         for n in ema}
    return rec


def compare_training(record: dict, ref: dict) -> dict:
    """The training numbers of ``record`` against the reference's ``ref``:
    ``loss1_gap`` (the first step's loss) and ``loss_gap`` (every step's,
    the widest); ``grad_cos_gap``, one minus the cosine between the two
    first clipped gradients over the kept leaves; for the first clipped
    gradient, the change over the
    steps and the EMA's change, the widest leaf gap (``grad_gap``,
    ``change_gap``, ``ema_gap``) and the median leaf's (``*_med_gap``).
    Leaves whose reference gradient is under a thousandth of the median
    leaf's are left out."""
    med = float(np.median(list(ref["grad_norm"].values())))

    def moved(n):
        return ref["grad_norm"][n] >= 1e-3 * med

    gaps = [abs(a - b) / abs(b) for a, b in zip(record["loss"], ref["loss"])]
    out = {"loss1_gap": gaps[0], "loss_gap": max(gaps)}
    kept = [n for n in ref["grad_norm"] if moved(n)]
    dev = ref["grad"][kept[0]].device
    def laid_out(n):
        # the program keeps recurrent weights transposed, (in, gates)
        g = record["grad"][n].to(dev)
        return g if g.shape == ref["grad"][n].shape else g.T

    a = torch.cat([laid_out(n).flatten() for n in kept]).double()
    b = torch.cat([ref["grad"][n].flatten() for n in kept]).double()
    out["grad_cos_gap"] = float(1.0 - torch.dot(a, b) / (
        torch.linalg.norm(a) * torch.linalg.norm(b)))
    worst = {"loss": [record["loss"], ref["loss"]]}
    for number, key in (("grad", "grad_norm"), ("change", "change"),
                        ("ema", "ema_change")):
        leaves = _leaf_gaps(record[key], ref[key], moved)
        out[f"{number}_gap"], worst[number] = leaves[0]
        out[f"{number}_med_gap"] = leaves[len(leaves) // 2][0]
    out["worst"] = worst
    return out


def judge_training(cell, seed: int, record: dict, device) -> dict:
    """The program's record against the float32 reference's."""
    ref = reference_record(cell, seed, device)
    return dict(compare_training(record, ref), ref=ref)
