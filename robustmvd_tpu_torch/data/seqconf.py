"""Sample generation of the sequence datasets (the JAX package's
``data/seqconf.py``).

StaticThings3D and FlyingThings3D build their training samples the same way
(reference: rmvd/data/staticthings3d.py:139-242 and
rmvd/data/flyingthings3d.py:869-971, near-duplicated there): walk
``<root>/*/*[0-9]`` sequences, and for each sample configuration and each
keyframe in 6..15, emit a sample when every configured file exists and is
not filtered.
"""

from __future__ import annotations

import os.path as osp
from glob import glob


class DataConf:
    """A (data-id, camera perspective, frame offset) spec

    (reference: staticthings3d.py:38-70, flyingthings3d.py:766-800)."""

    def __init__(self, id, perspective=None, offset=0, ext_map=None):
        self.id = id
        self.perspective = perspective
        self.offset = offset
        self._ext_map = ext_map or {}

    @property
    def ext(self):
        if self.id in self._ext_map:
            return self._ext_map[self.id]
        if self.id in ("frames_cleanpass", "frames_finalpass"):
            return "png"
        if self.id in ("poses", "intrinsics"):
            return self._ext_map.get("default_calib", "float3")
        if self.id == "disparities":
            return "pfm"
        return "float3"

    @property
    def perspective_short(self):
        return None if self.perspective is None else self.perspective[0]

    @property
    def path(self):
        if self.perspective is None:
            return self.id
        return osp.join(self.id, self.perspective)


def generate_sequence_samples(
    root,
    sample_confs,
    sample_cls,
    keyframes=range(6, 16),
    filtered_ids=(),
):
    """Emit samples for every (sequence, sample_conf, keyframe) combination

    where all configured files exist and no referenced frame is in
    ``filtered_ids`` (a set of (sequence_id, "NNNN") tuples).
    """
    filtered = {tuple(x) for x in filtered_ids}
    samples = []
    sequences = sorted(glob(osp.join(root, "*/*[0-9]")))
    root_tail = osp.split(root)[1]

    for sequence in sequences:
        sequence_files = {
            osp.relpath(f, sequence) for f in glob(osp.join(sequence, "*/*/*"))
        }
        seq_rel = osp.relpath(sequence, root)
        sequence_id = osp.join(root_tail, seq_rel)

        for sample_conf in sample_confs:
            for keyframe_num in keyframes:
                sample = sample_cls(
                    base=seq_rel, name=f"{seq_rel}/key{keyframe_num:02d}"
                )

                def resolve(conf):
                    offset_num = keyframe_num + conf.offset
                    filename = f"{offset_num:04d}.{conf.ext}"
                    if osp.join(conf.path, filename) not in sequence_files:
                        return None
                    if (sequence_id, f"{offset_num:04d}") in filtered:
                        return None
                    return (conf.perspective_short, offset_num)

                valid = True
                for key, conf in sample_conf.items():
                    if isinstance(conf, DataConf):
                        entry = resolve(conf)
                        if entry is None:
                            valid = False
                            break
                        sample.data[key] = entry
                    elif isinstance(conf, list):
                        entries = []
                        for c in conf:
                            entry = resolve(c)
                            if entry is None:
                                valid = False
                                break
                            entries.append(entry)
                        if not valid:
                            break
                        sample.data[key] = entries
                    else:
                        sample.data[key] = conf

                if valid:
                    samples.append(sample)

    return samples
