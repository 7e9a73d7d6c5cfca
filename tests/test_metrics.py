"""Metric-engine tests: the vectorized accumulators must match a direct
line-by-line transcription of the reference eval loop's boolean sums
(``evaluation_vit.py:291-463,485-575``) on random data, and the log writer
must emit the reference's exact line structure (checked against the golden
log when the reference checkout is present)."""

import io
import re

import numpy as np
import pytest

from tests import conftest as C
from vit_grid_model_tpu.evaluation import logwriter
from vit_grid_model_tpu.evaluation.metrics import (EvaluationMetrics,
                                                   assign_class_eval)


def _naive_reference_accumulation(batches, L):
    """Straight transcription of the reference's scalar accumulations."""
    conf = {k: np.zeros((4, 4)) for k in
            ("model", "persist", "sim_21h", "sim_avg")}
    TP = {k: np.zeros(3 * L) for k in conf}
    TN = {k: np.zeros(3 * L) for k in conf}
    FP = {k: np.zeros(3 * L) for k in conf}
    FN = {k: np.zeros(3 * L) for k in conf}
    SQ = {k: np.zeros(3 * L) for k in conf}
    AB = {k: np.zeros(3 * L) for k in conf}
    valid_count = np.zeros(3 * L)
    sums = {k: dict(absd=0.0, sq=0.0, bias=0.0, n=0) for k in conf}
    all_vals = {k: [] for k in conf}
    all_truth = []

    for batch in batches:
        truth = batch["truth"]
        tc = batch["truth_cls"]
        all_truth.append(truth.ravel())
        for name in conf:
            v = batch[name]
            cls = assign_class_eval(v)
            all_vals[name].append(v.ravel())
            for a in range(4):
                for b in range(4):
                    conf[name][a, b] += ((cls == a) & (tc == b)).sum()
            d = v - truth
            sums[name]["absd"] += np.abs(d).sum()
            sums[name]["sq"] += (d ** 2).sum()
            sums[name]["bias"] += d.sum()
            sums[name]["n"] += v.size
            for i in range(1, 4):
                for j in range(L):
                    cl, ct = cls[:, j], tc[:, j]
                    k = (i - 1) * L + j
                    TP[name][k] += ((cl > i - 1) & (ct > i - 1)).sum()
                    TN[name][k] += ((cl < i) & (ct < i) & (ct > -1)).sum()
                    FP[name][k] += ((cl > i - 1) & (ct < i) & (ct > -1)).sum()
                    FN[name][k] += ((cl < i) & (ct > i - 1)).sum()
                    sel = ct > i - 1
                    SQ[name][k] += ((v[:, j][sel] - truth[:, j][sel]) ** 2).sum()
                    AB[name][k] += np.abs(v[:, j][sel] - truth[:, j][sel]).sum()
        for i in range(1, 4):
            for j in range(L):
                valid_count[(i - 1) * L + j] += (tc[:, j] > i - 1).sum()

    return dict(conf=conf, TP=TP, TN=TN, FP=FP, FN=FN, SQ=SQ, AB=AB,
                valid_count=valid_count, sums=sums,
                all_vals={k: np.concatenate(v) for k, v in all_vals.items()},
                all_truth=np.concatenate(all_truth))


def _random_batches(rng, n_batches=3, B=4, L=5, cells=60):
    batches = []
    for _ in range(n_batches):
        truth = rng.random((B, L, cells)).astype(np.float32) * 90
        tc = assign_class_eval(truth)
        # sprinkle some truth NaN-class cells (-1)
        tc = np.where(rng.random(tc.shape) < 0.03, -1, tc)
        batches.append({
            "truth": truth, "truth_cls": tc,
            "model": (truth + rng.normal(0, 8, truth.shape)).clip(0).astype(np.float32),
            "persist": rng.random(truth.shape).astype(np.float32) * 90,
            "sim_21h": rng.random(truth.shape).astype(np.float32) * 90,
            "sim_avg": rng.random(truth.shape).astype(np.float32) * 90,
        })
    return batches


def test_metrics_match_reference_transcription():
    rng = np.random.default_rng(7)
    L = 5
    batches = _random_batches(rng, L=L)
    m = EvaluationMetrics(L)
    for b in batches:
        m.update(model=b["model"], persist=b["persist"],
                 sim_21h=b["sim_21h"], sim_avg=b["sim_avg"],
                 truth=b["truth"], truth_cls=b["truth_cls"])
    ref = _naive_reference_accumulation(batches, L)

    for name in EvaluationMetrics.PREDICTORS:
        s = m.stats[name]
        np.testing.assert_allclose(s.confusion, ref["conf"][name])
        np.testing.assert_allclose(s.lead_tp, ref["TP"][name])
        np.testing.assert_allclose(s.lead_tn, ref["TN"][name])
        np.testing.assert_allclose(s.lead_fp, ref["FP"][name])
        np.testing.assert_allclose(s.lead_fn, ref["FN"][name])
        np.testing.assert_allclose(s.lead_sq, ref["SQ"][name], rtol=1e-6)
        np.testing.assert_allclose(s.lead_abs, ref["AB"][name], rtol=1e-6)
        np.testing.assert_allclose(s.abs_sum, ref["sums"][name]["absd"],
                                   rtol=1e-6)
        np.testing.assert_allclose(s.sq_sum, ref["sums"][name]["sq"],
                                   rtol=1e-6)
        # Pearson vs the reference's centered-list formula
        x = ref["all_vals"][name].astype(np.float64)
        y = ref["all_truth"].astype(np.float64)
        xc, yc = x - x.mean(), y - y.mean()
        r_ref = (xc * yc).sum() / np.sqrt((xc ** 2).sum() * (yc ** 2).sum())
        np.testing.assert_allclose(s.pearson_r(), r_ref, rtol=1e-6)
        # NMB/NME normalized by sum of truth
        np.testing.assert_allclose(
            s.nmb(), ref["sums"][name]["bias"] / y.sum() * 100, rtol=1e-5)
    np.testing.assert_allclose(m.valid_count, ref["valid_count"])


def _generated_log_lines(L=12):
    rng = np.random.default_rng(0)
    m = EvaluationMetrics(L)
    for b in _random_batches(rng, n_batches=2, B=3, L=L, cells=50):
        m.update(model=b["model"], persist=b["persist"],
                 sim_21h=b["sim_21h"], sim_avg=b["sim_avg"],
                 truth=b["truth"], truth_cls=b["truth_cls"])
    buf = io.StringIO()
    logwriter.write_log(buf, m, args_repr="Namespace(test=1)")
    return buf.getvalue().splitlines()


def test_log_structure_matches_golden():
    lines = _generated_log_lines()
    # scalar block labels in order
    labels = [ln.split(":")[0] for ln in lines[1:37]]
    for prefix in ("persist", "model", "sim 21h", "sim avg"):
        for metric in ("total ACC", "total POD", "total FAR",
                       "total F1 score", "MAE", "RMSE", "NMB", "NME", "R"):
            assert f"{prefix} {metric}" in labels
    # table headers present
    joined = "\n".join(lines)
    for title in ("persistance model CSI", "MultiAir RMSE",
                  "simulation 21h F1", "simulation avg MAE"):
        assert f"{title}:" in joined


@pytest.mark.skipif(not C.reference_available(),
                    reason="reference checkout not mounted")
def test_log_line_labels_match_golden_log():
    """The generated log's line labels must equal the shipped golden log's,
    line for line (values differ; structure must not)."""
    golden = open(C.REFERENCE_SRC.replace(
        "/src", "/logs/test_simulation_vit_model_12hr.log")).read().splitlines()
    ours = _generated_log_lines(L=12)
    assert len(ours) == len(golden), (len(ours), len(golden))

    def label(line):
        if ":" in line and not line.lstrip().startswith(("0", "1", "2", "3",
                                                         "4", "5", "6", "7",
                                                         "8", "9")):
            return line.split(":")[0]
        # table body/header line: keep only the non-numeric skeleton
        # (column widths vary with the printed values)
        return re.sub(r"\s+", " ", re.sub(r"[-\d.na]+", "#", line)).strip()

    # line 0 is the argparse Namespace repr (content naturally differs)
    for i, (a, b) in enumerate(zip(ours[1:], golden[1:]), start=1):
        assert label(a) == label(b), f"line {i}: {a!r} vs {b!r}"


def test_f1_empty_event_classes_yields_nan_not_crash():
    """Review fix: pod=0 and far=1 (all high-class predictions wrong, no
    high-class hits) must produce the reference's quiet 0/0 NaN, not a
    Python ZeroDivisionError."""
    from vit_grid_model_tpu.evaluation.metrics import HIGH, PredictorStats

    s = PredictorStats(output_dim=2)
    s.confusion[0, HIGH] = 3     # truth high, predicted low  -> pod = 0
    s.confusion[HIGH, 0] = 2     # predicted high, truth low  -> far = 1
    assert np.isnan(s.f1())


@pytest.mark.parametrize("hour_index", [True, False], ids=["hours", "ints"])
@pytest.mark.parametrize("output_dim", [2, 6, 12])
def test_table_str_matches_pandas(output_dim, hour_index):
    """The pandas-free table layout is byte-identical to the
    ``DataFrame.to_string`` the reference prints, across magnitudes, signs,
    NaN, inf and all-NaN columns."""
    pd = pytest.importorskip("pandas")

    def pandas_table(values):
        L = output_dim
        frame = pd.DataFrame({"> 15": values[:L], "> 35": values[L:2 * L],
                              "> 75": values[2 * L:]})
        if hour_index:
            frame.index = [f"{i}H" for i in range(1, L + 1)]
        with pd.option_context("display.float_format", "{:.4f}".format):
            return frame.to_string()

    rng = np.random.default_rng(output_dim)
    n = 3 * output_dim
    for trial in range(60):
        v = rng.standard_normal(n) * 10.0 ** rng.integers(-3, 7, n)
        v[rng.random(n) < rng.random()] = np.nan
        if trial % 5 == 0:                       # one all-NaN column
            c = trial % 3
            v[c * output_dim:(c + 1) * output_dim] = np.nan
        if trial % 7 == 0:
            v[rng.integers(0, n)] = rng.choice([np.inf, -np.inf])
        assert logwriter._table_str(v, output_dim, hour_index) \
            == pandas_table(v)
