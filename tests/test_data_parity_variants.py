"""Byte-level parity of EVERY remaining dataset variant against the actual
reference torch classes run on the same inputs.

``_only`` and ``_v3`` parity lives in test_data.py; this module covers the
other nine: the five in-memory station variants, ``_w_curr``, the lazy
``_v2``, ``_with_station_imgs`` and ``_by_stn``.  Each test instantiates
ours and theirs with identical arrays / the shared synthetic tree and
asserts every element of the returned tuple with rtol 1e-6.
"""

from datetime import datetime

import numpy as np
import pytest

from tests import conftest as C
from vit_grid_model_tpu.data import readers, synthetic
from vit_grid_model_tpu.data import timeutil as TU

pytestmark = pytest.mark.skipif(not C.reference_available(),
                                reason="reference checkout not mounted")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("synth_variants")
    paths = synthetic.generate_tree(
        str(root), datetime(2023, 1, 10, 0), datetime(2023, 1, 10, 6),
        prev_len=4, output_dim=2, korea_stn_num=8, china_stn_num=3)
    times = TU.eval_time_list(datetime(2023, 1, 10, 0),
                              datetime(2023, 1, 10, 6), 4, 2)
    synthetic.write_station_images(paths["data_path"], times, output_dim=2)
    readers.clear_caches()
    return paths


def _times():
    return TU.eval_time_list(datetime(2023, 1, 10, 0),
                             datetime(2023, 1, 10, 6), 4, 2)


def _feats(times, total_stn=11, feat_dim=12):
    """Station features with a non-trivial validity flag in column 6 so the
    inverted-vs-raw mask quirks actually bite."""
    rng = np.random.default_rng(7)
    f = (rng.random((len(times), total_stn, feat_dim)) * 60).astype(np.float32)
    f[:, :, 6] = rng.integers(0, 2, (len(times), total_stn)).astype(np.float32)
    m = rng.integers(0, 2, (len(times), total_stn)).astype(np.float64)
    return f, m


DIMS = dict(input_dim=3, output_dim=2, prev_len=4,
            korea_stn_num=8, china_stn_num=3)
DIMS_POS = (3, 2, 4, 8, 3)          # positional form for the reference ctors


def _assert_tuples_equal(ours, theirs, names=None):
    theirs = [t.numpy() if hasattr(t, "numpy") else np.asarray(t)
              for t in theirs]
    assert len(ours) == len(theirs)
    for i, (x, y) in enumerate(zip(ours, theirs)):
        label = names[i] if names else str(i)
        np.testing.assert_allclose(
            np.asarray(x, dtype=np.float64), np.asarray(y, dtype=np.float64),
            rtol=1e-6, atol=1e-5, err_msg=label)


def _check_all_indices(ours, theirs, names=None):
    assert len(ours) == len(theirs)
    for idx in (0, len(ours) - 1):
        _assert_tuples_equal(ours[idx], theirs[idx], names)


def test_fixed_sat_parity(tree):
    C.add_reference_to_path()
    import dataset as ref

    from vit_grid_model_tpu.data.datasets import AirWithFixedSatDataset

    times = _times()
    feats, masks = _feats(times)
    rng = np.random.default_rng(1)
    sat_out = rng.random((len(times), 11, 2)).astype(np.float32)
    sat_in = rng.random((len(times), 11, 13)).astype(np.float32)
    ours = AirWithFixedSatDataset(times, sat_out, sat_in, feats, masks,
                                  **DIMS)
    theirs = ref.Air_with_fixed_Sat_Dataset(times, sat_out, sat_in, feats,
                                            masks, *DIMS_POS)
    _check_all_indices(ours, theirs,
                       ["feats", "masks", "sat_out", "sat_in", "cls",
                        "vals", "mask", "raw_times", "prev"])


def test_with_simulation_parity(tree):
    C.add_reference_to_path()
    import dataset as ref

    from vit_grid_model_tpu.data.datasets import AirWithSimulationDataset

    times = _times()
    feats, masks = _feats(times)
    sim = np.random.default_rng(2).random(
        (len(times), 11, 30)).astype(np.float32)
    ours = AirWithSimulationDataset(times, feats, masks, sim, **DIMS)
    theirs = ref.Air_with_Simulation_Dataset(times, feats, masks, sim,
                                             *DIMS_POS)
    _check_all_indices(ours, theirs,
                       ["feats", "masks", "sim", "cls", "vals", "mask",
                        "raw_times", "prev"])


def test_air_only_parity(tree):
    C.add_reference_to_path()
    import dataset as ref

    from vit_grid_model_tpu.data.datasets import AirOnlyDataset

    times = _times()
    feats, masks = _feats(times)
    ours = AirOnlyDataset(times, feats, masks, **DIMS)
    theirs = ref.Air_only_Dataset(times, feats, masks, *DIMS_POS)
    _check_all_indices(ours, theirs,
                       ["feats", "masks", "cls", "vals", "mask",
                        "raw_times", "prev"])


def test_with_simulation_v2_parity(tree):
    C.add_reference_to_path()
    import dataset as ref

    from vit_grid_model_tpu.data.datasets import AirWithSimulationDatasetV2

    times = _times()
    feats, masks = _feats(times)
    rng = np.random.default_rng(3)
    sim = rng.random((len(times), 11, 30)).astype(np.float32)
    sim_pm = rng.random((len(times), 11)).astype(np.float32)
    ours = AirWithSimulationDatasetV2(times, feats, masks, sim, sim_pm,
                                      **DIMS)
    theirs = ref.Air_with_Simulation_Dataset_v2(times, feats, masks, sim,
                                                sim_pm, *DIMS_POS)
    _check_all_indices(ours, theirs,
                       ["feats", "masks", "sim", "sim_pm", "cls", "vals",
                        "mask", "raw_times", "prev"])


def test_reanalysis_inmem_parity(tree):
    C.add_reference_to_path()
    import dataset as ref

    from vit_grid_model_tpu.data.datasets import AirSimulationReanalysisDataset

    times = _times()
    feats, masks = _feats(times)
    rng = np.random.default_rng(4)
    sim = rng.random((len(times), 11, 30)).astype(np.float32)
    # span the class boundaries (incl. values <= -1 -> class -1 default)
    re = (rng.random((len(times), 82, 67)) * 100 - 5).astype(np.float32)
    ours = AirSimulationReanalysisDataset(times, feats, masks, sim, re,
                                          **DIMS)
    theirs = ref.Air_Simulation_Reanalysis_Dataset(times, feats, masks, sim,
                                                   re, *DIMS_POS)
    _check_all_indices(ours, theirs,
                       ["feats", "masks", "sim", "re", "cls",
                        "raw_times", "prev"])


def test_reanalysis_w_curr_parity(tree):
    C.add_reference_to_path()
    import dataset as ref

    from vit_grid_model_tpu.data.datasets import (
        AirSimulationReanalysisDatasetWithCurr)

    times = _times()
    feats, masks = _feats(times)
    rng = np.random.default_rng(5)
    sim = rng.random((len(times), 11, 30)).astype(np.float32)
    re = (rng.random((len(times), 82, 67)) * 100 - 5).astype(np.float32)
    ours = AirSimulationReanalysisDatasetWithCurr(times, feats, masks, sim,
                                                  re, **DIMS)
    theirs = ref.Air_Simulation_Reanalysis_Dataset_w_curr(
        times, feats, masks, sim, re, *DIMS_POS)
    _check_all_indices(ours, theirs,
                       ["feats", "masks", "sim", "curr", "re", "cls",
                        "raw_times", "prev"])


def _lazy_kwargs(tree):
    return dict(cmaq_size=(82, 67), sim_data_path=tree["sim_data_path"],
                reanalysis_data_path=tree["analysis_data_path"],
                feat_infos=synthetic.DEFAULT_FEAT_INFOS, **DIMS)


def test_lazy_v2_parity(tree):
    C.add_reference_to_path()
    import dataset as ref

    from vit_grid_model_tpu.data.datasets import (
        AirSimulationReanalysisDatasetV2)

    times = _times()
    feats, masks = _feats(times)
    ours = AirSimulationReanalysisDatasetV2(times, feats, masks,
                                            **_lazy_kwargs(tree))
    theirs = ref.Air_Simulation_Reanalysis_Dataset_v2(
        times, feats, masks, *DIMS_POS, (82, 67), tree["sim_data_path"],
        tree["analysis_data_path"], synthetic.DEFAULT_FEAT_INFOS)
    _check_all_indices(ours, theirs,
                       ["feats", "masks", "sim", "re", "cls",
                        "raw_times", "prev"])


def test_with_station_imgs_parity(tree):
    C.add_reference_to_path()
    import dataset as ref

    from vit_grid_model_tpu.data.datasets import (
        AirSimulationReanalysisDatasetWithStationImgs)

    times = _times()
    feats, masks = _feats(times)
    kw = _lazy_kwargs(tree)
    ours = AirSimulationReanalysisDatasetWithStationImgs(
        times, feats, masks, data_path=tree["data_path"], **kw)
    theirs = ref.Air_Simulation_Reanalysis_Dataset_with_station_imgs(
        times, feats, masks, *DIMS_POS, (82, 67), tree["sim_data_path"],
        tree["analysis_data_path"], tree["data_path"],
        synthetic.DEFAULT_FEAT_INFOS)
    _check_all_indices(ours, theirs,
                       ["sim", "curr", "re", "cls", "raw_times", "prev",
                        "stn_inputs", "multiair_out"])


def test_by_stn_parity(tree):
    C.add_reference_to_path()
    import dataset as ref

    from vit_grid_model_tpu.data.datasets import (
        AirSimulationReanalysisDatasetByStn)

    times = _times()
    feats, masks = _feats(times)
    ours = AirSimulationReanalysisDatasetByStn(times, feats, masks,
                                               **_lazy_kwargs(tree))
    theirs = ref.Air_Simulation_Reanalysis_Dataset_by_stn(
        times, feats, masks, *DIMS_POS, (82, 67), tree["sim_data_path"],
        tree["analysis_data_path"], synthetic.DEFAULT_FEAT_INFOS)
    _check_all_indices(ours, theirs,
                       ["feats", "masks", "sim", "curr", "re", "cls",
                        "raw_times", "prev", "stn_vals", "stn_mask",
                        "stn_cls"])
