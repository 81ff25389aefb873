"""Write tests/fixtures/torch_keras_resnet50_224.json: the `model_config`
attribute of the HDF5 file that tf_keras writes for its ResNet-50 at
224 x 224 x 3 with 1000 classes (no weights).

The card's machine has no tf_keras and no h5py, so the full-width
ResNet-50 import runs there through the separate-configuration path from
this file (chip_smoke.py phase 5f). The file holds the attribute as
tf_keras writes it into the .h5 (`model.to_json()` adds each layer's
`module` and `registered_name` and the top-level `keras_version` and
`backend`, which the import ignores); tests/test_torch_keras_resnet50.py
checks that it equals the `model_config` of the file tf_keras writes now.

Run from the repository root (needs tf_keras and h5py): ``python
tests/fixtures/generate_torch_keras_resnet50_json.py``.
"""
import os
import tempfile


def main() -> None:
    os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "3")
    os.environ.setdefault("CUDA_VISIBLE_DEVICES", "")
    import h5py
    import tf_keras as keras
    m = keras.applications.ResNet50(weights=None, input_shape=(224, 224, 3),
                                    classes=1000)
    with tempfile.TemporaryDirectory() as tmp:
        h5 = os.path.join(tmp, "resnet50.h5")
        m.save(h5, save_format="h5")
        with h5py.File(h5, "r") as f:
            text = f.attrs["model_config"]
    out = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "torch_keras_resnet50_224.json")
    with open(out, "w") as f:
        f.write(text)
    print(out, os.path.getsize(out), "bytes,", m.count_params(), "params")


if __name__ == "__main__":
    main()
