"""joblib interop (the counterpart of ``dask_ml_tpu/joblib.py``; dask-ml's
``joblib.py`` registers the distributed joblib backend on import).

No backend is registered here: the port's estimators pickle with stock
joblib (a fitted estimator's tensors travel with it), and scikit-learn's
``n_jobs`` threads may call them directly. The module exists for import
parity::

    import joblib
    joblib.dump(fitted_estimator, "model.joblib")
    est = joblib.load("model.joblib")
"""

from dask_ml_tpu_torch.interop import export_learned_attrs, to_numpy  # noqa: F401
