"""XGBoost hand-off (the counterpart of ``dask_ml_tpu/xgboost.py``; dask-ml
re-exports ``dask-xgboost``).

The card is not an XGBoost runtime, so the surface is the hand-off: copy
the staged features to the host and feed xgboost's own trainer::

    from dask_ml_tpu_torch.xgboost import to_numpy
    import xgboost as xgb
    dtrain = xgb.DMatrix(to_numpy(Xd), label=to_numpy(yd))
    booster = xgb.train(params, dtrain)

``to_numpy`` drops the rows past a staged ``DeviceData``'s ``n``, so the
labels stay aligned. xgboost is never imported here.
"""

from dask_ml_tpu_torch.interop import export_learned_attrs, to_numpy  # noqa: F401
