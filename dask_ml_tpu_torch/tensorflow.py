"""TensorFlow hand-off (the counterpart of ``dask_ml_tpu/tensorflow.py``;
dask-ml re-exports ``dask-tensorflow``'s cluster bootstrap).

Here the hand-off is the data: host arrays feed ``tf.data``, and a fitted
model's state moves as plain ndarrays::

    from dask_ml_tpu_torch.tensorflow import to_numpy, export_learned_attrs
    ds = tf.data.Dataset.from_tensor_slices((to_numpy(Xd), to_numpy(yd)))
    weights = export_learned_attrs(fitted_estimator)

tensorflow is never imported here.
"""

from dask_ml_tpu_torch.interop import export_learned_attrs, to_numpy  # noqa: F401
