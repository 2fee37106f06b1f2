"""The port's copy of the data modules (`repro_torch.data`, numpy only):
the reference's test_data_pipeline.py case for case (property tests for
the paper's preprocessing best-practices: [0,1] scaling, one-hot labels,
80/20 split, zero-filled missing values, CSV structural-error semantics),
and the copies' outputs against the reference's for the same seeds: the
synthetic CSV and arrays, the prepared dataset, minibatches and the LM
`TokenStream`, bit for bit."""
import numpy as np
import pytest

from _hyp import given, settings, st

from repro_torch.data import pipeline, synthetic

finite_floats = st.floats(allow_nan=False, allow_infinity=False,
                          min_value=-1e6, max_value=1e6, width=32)


@given(st.lists(st.lists(finite_floats, min_size=3, max_size=3),
                min_size=4, max_size=50))
@settings(max_examples=50, deadline=None)
def test_scale_unit_range_property(rows):
    x = np.array(rows, np.float64)
    scaled, lo, hi = pipeline.scale_unit(x)
    assert scaled.min() >= 0.0 and scaled.max() <= 1.0
    # columns with spread hit both endpoints
    span = x.max(0) - x.min(0)
    for j in range(x.shape[1]):
        if span[j] > 0:
            assert np.isclose(scaled[:, j].min(), 0.0)
            assert np.isclose(scaled[:, j].max(), 1.0)
        else:
            assert (scaled[:, j] == 0).all()


@given(st.lists(st.sampled_from(["a", "b", "c", "d"]), min_size=1,
                max_size=100))
@settings(max_examples=50, deadline=None)
def test_one_hot_property(labels):
    oh, classes = pipeline.one_hot_labels(labels)
    assert oh.shape == (len(labels), len(classes))
    assert (oh.sum(axis=1) == 1).all()
    # invertible
    rec = [classes[i] for i in oh.argmax(axis=1)]
    assert rec == [str(l) for l in labels]


@given(st.integers(min_value=10, max_value=500),
       st.integers(min_value=0, max_value=10_000))
@settings(max_examples=50, deadline=None)
def test_split_property(n, seed):
    x = np.arange(n * 2, dtype=np.float64).reshape(n, 2)
    y = np.zeros((n, 2), np.float32)
    xtr, ytr, xte, yte = pipeline.train_test_split(x, y, seed=seed)
    assert len(xte) == int(round(n * 0.2))
    assert len(xtr) + len(xte) == n
    # partition: no row lost or duplicated
    allrows = np.concatenate([xtr[:, 0], xte[:, 0]])
    assert sorted(allrows.tolist()) == sorted(x[:, 0].tolist())


def test_fill_missing_zero():
    x = np.array([[1.0, np.nan], [np.inf, 2.0]])
    out = pipeline.fill_missing(x)
    assert out[0, 1] == 0.0 and out[1, 0] == 0.0
    assert out[0, 0] == 1.0 and out[1, 1] == 2.0


def test_csv_structural_error_aborts():
    with pytest.raises(pipeline.CSVFormatError):
        pipeline.parse_csv("a,b\n1,2\n3")       # ragged row
    with pytest.raises(pipeline.CSVFormatError):
        pipeline.parse_csv("")
    with pytest.raises(pipeline.CSVFormatError):
        pipeline.prepare("a,b\n1,2", label="nope")


def test_missing_values_are_not_errors():
    """Paper: 'missing data was not considered an error'."""
    csv = "f0,f1,label\n" + "1.0,,x\n,2.0,y\n0.5,0.5,x\n0.1,0.2,y\n" * 3
    ds = pipeline.prepare(csv, "label")
    assert np.isfinite(ds.x_train).all()
    assert ds.n_classes == 2


def test_prepare_end_to_end_stats():
    csv = synthetic.classification_csv(500, 6, 3, seed=1)
    ds = pipeline.prepare(csv, "label", seed=1)
    assert ds.x_train.shape[1] == 6 and ds.n_classes == 3
    assert 0 <= ds.x_train.min() and ds.x_train.max() <= 1.0
    assert len(ds.x_test) == 100
    # test scaling reuses train stats -> may clip but stays in range
    assert 0 <= ds.x_test.min() and ds.x_test.max() <= 1.0


# ---- against the reference

def _ref():
    pytest.importorskip("jax")
    from repro.data import pipeline as ref_pipeline
    from repro.data import synthetic as ref_synthetic
    from repro.data import tokens as ref_tokens
    return ref_pipeline, ref_synthetic, ref_tokens


@pytest.mark.parametrize("seed", [0, 7])
def test_token_stream_matches_reference(seed):
    from repro_torch.data.tokens import TokenStream
    _, _, ref_tokens = _ref()
    for kw in ({}, {"branch": 4, "order": 2}):
        ours = TokenStream(512, 24, 3, seed=seed, **kw)
        ref = ref_tokens.TokenStream(512, 24, 3, seed=seed, **kw)
        for (a, b), _ in zip(zip(ours, ref), range(4)):
            assert set(a) == set(b) == {"tokens", "labels"}
            for k in a:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])


def test_synthetic_and_prepared_dataset_match_reference():
    ref_pipeline, ref_synthetic, _ = _ref()
    csv = synthetic.classification_csv(300, 5, 3, seed=4)
    assert csv == ref_synthetic.classification_csv(300, 5, 3, seed=4)
    for a, b in zip(synthetic.classification_arrays(50, 4, 2, seed=1),
                    ref_synthetic.classification_arrays(50, 4, 2, seed=1)):
        np.testing.assert_array_equal(a, b)
    ds, ref = pipeline.prepare(csv, "label", seed=2), \
        ref_pipeline.prepare(csv, "label", seed=2)
    for f in ("x_train", "y_train", "x_test", "y_test"):
        np.testing.assert_array_equal(getattr(ds, f), getattr(ref, f))
    assert ds.classes == ref.classes
    assert ds.feature_names == ref.feature_names
    for a, b in zip(pipeline.batches(ds.x_train, ds.y_train, 32, seed=3),
                    ref_pipeline.batches(ref.x_train, ref.y_train, 32,
                                         seed=3)):
        np.testing.assert_array_equal(a["x"], b["x"])
        np.testing.assert_array_equal(a["y"], b["y"])
