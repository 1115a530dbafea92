"""Train/val/test splits (counterpart of mst_tpu/data/splits.py:10-143;
reference utils/data_utils.py:754-964).

The functions take and return track tables (data/tracks.py) and draw from
the global np.random stream exactly as mst_tpu does, so --shuffle under one
np.random.seed picks the same metaIds. The pickles are pandas DataFrames:
their readers import pandas when called, and nothing else here needs it.
The varf and given-scenes helpers are not ported.
"""

import os
import warnings

import numpy as np

from mst_tpu_torch.data.tracks import Tracks


def read_pickle(path) -> Tracks:
    """A pickled DataFrame of tracks -> its table."""
    import pandas as pd

    return Tracks.from_frame(pd.read_pickle(path))


def reduce_df_meta_ids(tracks, meta_ids):
    """The rows whose metaId is in meta_ids, in table order."""
    return tracks.take(np.isin(tracks.metaId, np.asarray(meta_ids)))


def dataset_split_by_ratio(tracks, val_split, test_split=None, shuffle=False,
                           share_val_test=False, given_test_meta_ids=None):
    """reference data_utils.py:770-809."""
    unique_meta_ids = np.unique(tracks.metaId)
    if shuffle:
        np.random.shuffle(unique_meta_ids)
    n = unique_meta_ids.shape[0]
    n_val = int(val_split) if val_split > 1 else int(val_split * n)
    if test_split is not None:
        n_test = int(test_split) if test_split > 1 else int(test_split * n)
        if share_val_test:
            n_train = n - n_test
            train_ids, test_ids = np.split(unique_meta_ids, [n_train])
            if n_val != 0:
                interval = n_test // n_val if n_test // n_val > 1 else 3
                val = reduce_df_meta_ids(tracks, test_ids[::interval])
            else:
                val = None
            test = reduce_df_meta_ids(tracks, test_ids)
        else:
            n_train = n - n_val - n_test
            train_ids, val_ids, test_ids = np.split(
                unique_meta_ids, [n_train, n_train + n_val])
            if given_test_meta_ids is not None:
                test_ids = given_test_meta_ids
            test = reduce_df_meta_ids(tracks, test_ids)
            val = reduce_df_meta_ids(tracks, val_ids)
    else:
        # the reference's quirk (data_utils.py:806-808), kept as mst_tpu
        # keeps it: the names are swapped against the sizes, so the first
        # n - n_val ids land in val and the last n_val in train
        n_train = n - n_val
        val_ids, train_ids = np.split(unique_meta_ids, [n_train])
        test = None
        val = reduce_df_meta_ids(tracks, val_ids)
    return reduce_df_meta_ids(tracks, train_ids), val, test


def split_train_val_test_sequentially(data_path, train_files, val_split,
                                      test_splits=None, shuffle=False,
                                      share_val_test=False):
    """reference data_utils.py:754-767."""
    if test_splits is None:
        raise ValueError(
            "sequential split needs --test_splits (one per --val_files "
            "entry); pass 0 for files that contribute no test set")
    if len(test_splits) < len(train_files):
        warnings.warn(
            f"{len(train_files)} train files but {len(test_splits)} "
            "test_splits: trailing files are DROPPED from all splits "
            "(reference zip-truncation semantics)", stacklevel=2)
    parts = ([], [], [])
    for train_file, test_split in zip(train_files, test_splits):
        tracks = read_pickle(os.path.join(data_path, train_file))
        for part, split in zip(parts, dataset_split_by_ratio(
                tracks, val_split, test_split, shuffle, share_val_test)):
            part.append(split)
    return tuple(Tracks.concat(p) for p in parts)


def load_predefined_train_val_test(data_path, batch_size, n_train_batch=None,
                                   shuffle=False):
    """reference data_utils.py:859-872."""
    train = read_pickle(f"{data_path}/train.pkl")
    val = read_pickle(f"{data_path}/val.pkl")
    test = read_pickle(f"{data_path}/test.pkl")
    if n_train_batch is not None:
        n_sample = int(batch_size * n_train_batch)
        ids = train.meta_ids()
        if n_sample > ids.shape[0]:
            raise ValueError(f"Training set size ({ids.shape[0]}) < Sample "
                             f"size ({n_sample})")
        if shuffle:
            np.random.shuffle(ids)
        train = reduce_df_meta_ids(train, ids[:n_sample])
    return train, val, test


def limit_samples(tracks, num, batch_size, random_ids=True):
    """Few-shot cap: num * batch_size metaIds (data_utils.py:955-964)."""
    if num is None:
        return tracks
    meta_ids = np.unique(tracks.metaId)
    if random_ids:
        np.random.shuffle(meta_ids)
    return reduce_df_meta_ids(tracks, meta_ids[:int(num * batch_size)])


def prepare_dataset(data_path, load_data, batch_size, n_train_batch,
                    train_files, val_files, val_split, test_splits,
                    shuffle, share_val_test, mode="train",
                    show_details=False):
    """reference prepare_dataeset (data_utils.py:875-912) -> (train, val,
    test) track tables."""
    if load_data == "predefined":
        train, val, test = load_predefined_train_val_test(
            data_path, batch_size=batch_size, n_train_batch=n_train_batch,
            shuffle=shuffle)
    elif mode == "train":
        if train_files is None:
            raise ValueError("No train file is provided")
        if val_files is None:
            raise ValueError("No val file is provided")
        if train_files != val_files:
            raise NotImplementedError
        train, val, test = split_train_val_test_sequentially(
            data_path, train_files, val_split, test_splits, shuffle,
            share_val_test)
        train = limit_samples(train, n_train_batch, batch_size)
    elif mode == "eval":
        if val_files is None:
            raise ValueError("No val file is provided")
        train, val, test = split_train_val_test_sequentially(
            data_path, val_files, val_split, test_splits, shuffle,
            share_val_test)
    else:
        raise NotImplementedError
    if show_details:
        for name, d in [("train", train), ("val", val), ("test", test)]:
            if d is not None and len(d):
                print(f"{name}_meta_ids: {d.meta_ids()}")
    return train, val, test
