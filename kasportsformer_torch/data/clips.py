"""Packed clip sets (port of `kasportsformer_tpu/data/clips.py`, numpy only).

* `ClipSet`: one split's clips as packed arrays;
* `save_clipstore` / `load_clipstore`: one `.npz` per split;
* `write_reference_clip_files` / `read_reference_clip_files`: the
  reference's one-pickle-per-clip directories (`clip_generate_sp.py:28-79`),
  so existing `data/clips/<SET>/{train,test}` trees load unchanged;
* `load_split`: `.npz`, then a reference directory. The KSF1 native store
  (`<split>.ksf`, a host library of the JAX package) is not ported yet: a
  split that only has one raises and says so.

Train labels are root-relative (`clip_generate_sp.py:39-40`); test labels
keep both the normalised and the 2.5D-scaled variants.
"""

from __future__ import annotations

import dataclasses
import os
import pickle

import numpy as np


@dataclasses.dataclass
class ClipSet:
    """One split's clips, packed. 'train' sets inputs and labels; 'test'
    carries the eval protocol's fields too."""

    split: str
    inputs: np.ndarray  # (N, T, 17, 3) float32
    labels: np.ndarray | None = None  # (N, T, 17, 3) (train: root-relative)
    labels_scaled: np.ndarray | None = None  # (N, T, 17, 3)
    factors: np.ndarray | None = None  # (N, T)
    actions: np.ndarray | None = None  # (N,) unicode
    res: np.ndarray | None = None  # (N, 2) as (res_w, res_h)
    envtags: np.ndarray | None = None  # (N,) unicode (SP only)

    def __len__(self) -> int:
        return len(self.inputs)


def _single(values, idx: int, what: str) -> str:
    uniq = set(np.asarray(values).tolist())
    if len(uniq) != 1:
        raise ValueError(f"clip {idx} contains more than one {what}: {uniq}")
    return str(next(iter(uniq)))


def clipsets_from_sliced(train_dict: dict, test_dict: dict,
                         root_rel: bool = True) -> tuple[ClipSet, ClipSet]:
    """ClipSets from a source reader's sliced dicts, with the reference's
    train-time root-relativisation (`clip_generate_sp.py:39-40`)."""
    train_labels = np.asarray(train_dict["label"], np.float32)
    if root_rel:
        train_labels = train_labels - train_labels[..., 0:1, :]
    train = ClipSet(split="train",
                    inputs=np.asarray(train_dict["data"], np.float32),
                    labels=train_labels)
    # per reference, a clip holds exactly one action (`:61-66`)
    actions = np.array([_single(a, i, "action")
                        for i, a in enumerate(test_dict["action"])])
    envtags = test_dict.get("envtag")
    if envtags is not None:
        envtags = np.array([_single(e, i, "envtag") for i, e in enumerate(envtags)])
    test = ClipSet(
        split="test",
        inputs=np.asarray(test_dict["data"], np.float32),
        labels=np.asarray(test_dict["label"], np.float32),
        labels_scaled=np.asarray(test_dict["label_scaled"], np.float32),
        factors=np.asarray(test_dict["factor"], np.float32),
        actions=actions,
        res=np.asarray(test_dict["test_hw"], np.float32),
        envtags=envtags)
    return train, test


# ------------------------------------------------------------ packed store

_NUMERIC = ("labels", "labels_scaled", "factors", "res")
_STRINGS = ("actions", "envtags")


def save_clipstore(path: str, clipset: ClipSet) -> None:
    """One compressed .npz per split."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    payload = {"split": np.array(clipset.split), "inputs": clipset.inputs}
    for name in _NUMERIC + _STRINGS:
        value = getattr(clipset, name)
        if value is not None:
            payload[name] = value
    np.savez_compressed(path, **payload)


def load_clipstore(path: str) -> ClipSet:
    with np.load(path, allow_pickle=False) as z:
        kwargs = {"split": str(z["split"]), "inputs": z["inputs"]}
        for name in _NUMERIC:
            if name in z:
                kwargs[name] = z[name]
        for name in _STRINGS:
            if name in z:
                kwargs[name] = z[name].astype(str)
    return ClipSet(**kwargs)


def clipstore_path(data_root: str, clip_set_name: str, split: str) -> str:
    return os.path.join(data_root, clip_set_name, f"{split}.npz")


def native_clipstore_path(data_root: str, clip_set_name: str, split: str) -> str:
    return os.path.join(data_root, clip_set_name, f"{split}.ksf")


# ------------------------------------------------ reference pkl interchange


def write_reference_clip_files(root_path: str, clipset: ClipSet) -> int:
    """Write the reference's one-pkl-per-clip layout (train: {data_input,
    data_label}; test adds data_label_scaled, data_factor, data_res,
    data_action[, data_env] — `clip_generate_sp.py:36-77`)."""
    out_dir = os.path.join(root_path, clipset.split)
    os.makedirs(out_dir, exist_ok=True)
    for i in range(len(clipset)):
        payload = {"data_input": clipset.inputs[i], "data_label": clipset.labels[i]}
        if clipset.split == "test":
            payload["data_label_scaled"] = clipset.labels_scaled[i]
            payload["data_factor"] = clipset.factors[i]
            payload["data_res"] = clipset.res[i]
            payload["data_action"] = str(clipset.actions[i])
            if clipset.envtags is not None:
                payload["data_env"] = str(clipset.envtags[i])
        with open(os.path.join(out_dir, "%08d.pkl" % i), "wb") as f:
            pickle.dump(payload, f)
    return len(clipset)


def read_reference_clip_files(root_path: str, split: str) -> ClipSet:
    """Load a reference-format clip directory into a packed ClipSet. The
    files are pickles: read only directories you trust."""
    clip_dir = os.path.join(root_path, split)
    fields: dict[str, list] = {k: [] for k in (
        "inputs", "labels", "labels_scaled", "factors", "actions", "res", "envtags")}
    for name in sorted(os.listdir(clip_dir)):
        with open(os.path.join(clip_dir, name), "rb") as f:
            payload = pickle.load(f)
        fields["inputs"].append(np.asarray(payload["data_input"], np.float32))
        if "data_label" in payload:
            fields["labels"].append(np.asarray(payload["data_label"], np.float32))
        if split == "test":
            fields["labels_scaled"].append(
                np.asarray(payload["data_label_scaled"], np.float32))
            fields["factors"].append(np.asarray(payload["data_factor"], np.float32))
            fields["actions"].append(str(payload["data_action"]))
            fields["res"].append(np.asarray(payload["data_res"], np.float32))
            if "data_env" in payload:
                fields["envtags"].append(str(payload["data_env"]))
    kwargs: dict = {"split": split}
    for name, values in fields.items():
        if values:
            kwargs[name] = (np.array(values) if name in _STRINGS
                            else np.stack(values))
    return ClipSet(**kwargs)


def load_split(data_root: str, clip_set_name: str, split: str) -> ClipSet:
    """Load a split: the packed .npz, then a reference-format directory."""
    packed = clipstore_path(data_root, clip_set_name, split)
    if os.path.exists(packed):
        return load_clipstore(packed)
    ref_dir = os.path.join(data_root, clip_set_name)
    if os.path.isdir(os.path.join(ref_dir, split)):
        return read_reference_clip_files(ref_dir, split)
    native = native_clipstore_path(data_root, clip_set_name, split)
    if os.path.exists(native):
        raise NotImplementedError(
            f"{native} is a KSF1 native clip store, which kasportsformer_torch "
            f"does not read yet; write the split as {packed} (what the JAX "
            f"package's `preprocess` writes by default) or as reference "
            f"pkl files")
    raise FileNotFoundError(
        f"no clip data for {clip_set_name}/{split} under {data_root} "
        f"(looked for {packed} and {ref_dir}/{split}/*.pkl)")
