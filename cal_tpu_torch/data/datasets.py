"""Real-dataset assembly: the ``feat_str`` grammar, ``get_dataset`` and the
per-dataset feature rules.

Counterpart of cal_tpu/data/datasets.py (the reference's ``datasets.py``
and ``opts.create_n_filter_triples``): builds a :class:`TUDataset` with a
:class:`FeatureExpander` pre-transform; edge attributes are dropped.
"""
from __future__ import annotations

import re
from itertools import product
from typing import List, Sequence, Tuple

from cal_tpu_torch.data.feature_expansion import FeatureExpander
from cal_tpu_torch.data.tu import TUDataset


def parse_feat_str(feat_str: str) -> dict:
    """The reference's regex grammar, bug for bug: ``degree`` is a substring
    test, so ``odeg10`` also turns the scalar degree on, and ``re(\\w+)``
    greedily matches ``reall``."""
    onehot = re.findall(r"odeg(\d+)", feat_str)
    k = re.findall(r"an{0,1}k(\d+)", feat_str)
    groupd = re.findall(r"groupd(\d+)", feat_str)
    remove_edges = re.findall(r"re(\w+)", feat_str)
    noise_add = re.findall(r"randa([\d\.]+)", feat_str)
    noise_del = re.findall(r"randd([\d\.]+)", feat_str)
    return {
        "degree": feat_str.find("deg") >= 0,
        "onehot_maxdeg": int(onehot[0]) if onehot else None,
        "AK": int(k[0]) if k else 0,
        "group_degree": int(groupd[0]) if groupd else 0,
        "remove_edges": remove_edges[0] if remove_edges else "none",
        "edge_noises_add": float(noise_add[0]) if noise_add else 0.0,
        "edge_noises_delete": float(noise_del[0]) if noise_del else 0.0,
        "centrality": feat_str.find("cent") >= 0,
        "coord": feat_str.find("coord") >= 0,
    }


def get_dataset(name: str, feat_str: str = "deg+odeg100", root: str = "data",
                pruning_percent: float = 0.0) -> TUDataset:
    """A TU dataset under ``root`` with the feature expansion that
    ``feat_str`` names."""
    f = parse_feat_str(feat_str)
    pre_transform = FeatureExpander(
        degree=f["degree"], onehot_maxdeg=f["onehot_maxdeg"], AK=f["AK"],
        centrality=f["centrality"], remove_edges=f["remove_edges"],
        edge_noises_add=f["edge_noises_add"], edge_noises_delete=f["edge_noises_delete"],
        group_degree=f["group_degree"])
    return TUDataset(root, name, pre_transform=pre_transform, use_node_attr=True,
                     feat_str=feat_str, pruning_percent=pruning_percent)


def create_n_filter_triples(datasets: Sequence[str], feat_strs: Sequence[str] = ("deg+odeg100",),
                            nets: Sequence[str] = ("ResGCN",)) -> List[Tuple[str, str, str]]:
    """(dataset, feat_str, net) per combination, with the reference's
    per-dataset feat_str rules (its flags for them are always on): REDDIT
    datasets (and their stand-in SYNREDDIT) take odeg10; DD (and SYNDD)
    odeg10 and ak1."""
    out = []
    for dataset, feat_str, net in product(datasets, feat_strs, nets):
        if dataset in ("REDDIT-BINARY", "REDDIT-MULTI-5K", "REDDIT-MULTI-12K", "SYNREDDIT"):
            feat_str = feat_str.replace("odeg100", "odeg10")
        if dataset in ("DD", "SYNDD"):
            feat_str = feat_str.replace("odeg100", "odeg10").replace("ak3", "ak1")
        out.append((dataset, feat_str, net))
    return out
