"""Feature quantization: BinMapper.

The port's own copy of ``lightgbm_tpu/io/binning.py``, so that bin
boundaries stay bit-identical to the JAX package's. Re-design of the
reference binning (include/LightGBM/bin.h:61-209,
src/io/bin.cpp FindBin/GreedyFindBin/FindBinWithZeroAsOneBin). Semantics are
kept bit-for-bit where it matters for split parity:

- greedy equal-count bin boundaries with ``min_data_in_bin`` and "big count
  value" handling;
- zero always gets its own bin (bins split around +/- kZeroThreshold);
- missing handling: MissingType None / Zero (zero bin doubles as missing) /
  NaN (dedicated last bin).

Numerical features only: categorical binning is outside the port so far.

Host-side (NumPy): binning runs once per dataset; the binned int matrix is the
device-resident artifact everything else trains on.
"""
from __future__ import annotations

import math
from typing import List

import numpy as np

from ..log import check, outside_slice

# bin.h kZeroThreshold
K_ZERO_THRESHOLD = 1e-35
_EPS = 1e-15


class MissingType:
    NONE = 0
    ZERO = 1
    NAN = 2


class BinType:
    NUMERICAL = 0
    CATEGORICAL = 1


def _get_double_upper_bound(x: float) -> float:
    """Common::GetDoubleUpperBound — nextafter so values == boundary bin left."""
    return math.nextafter(x, math.inf)


def _check_double_equal(a: float, b: float) -> bool:
    return b <= math.nextafter(a, math.inf)


def greedy_find_bin(distinct_values: np.ndarray, counts: np.ndarray,
                    max_bin: int, total_cnt: int, min_data_in_bin: int) -> List[float]:
    """Greedy equal-count boundary search (bin.cpp GreedyFindBin)."""
    num_distinct = len(distinct_values)
    bin_upper_bound: List[float] = []
    check(max_bin > 0, "max_bin should be > 0")
    # plain lists: the loops below are scalar-sequential (running counts and
    # adaptive thresholds), and numpy scalar indexing would dominate them
    dv = distinct_values.tolist()
    cn = counts.tolist()
    if num_distinct <= max_bin:
        cur_cnt = 0
        for i in range(num_distinct - 1):
            cur_cnt += cn[i]
            if cur_cnt >= min_data_in_bin:
                val = _get_double_upper_bound((dv[i] + dv[i + 1]) / 2.0)
                if not bin_upper_bound or not _check_double_equal(bin_upper_bound[-1], val):
                    bin_upper_bound.append(val)
                    cur_cnt = 0
        bin_upper_bound.append(float("inf"))
        return bin_upper_bound

    if min_data_in_bin > 0:
        max_bin = max(1, min(max_bin, total_cnt // min_data_in_bin))
    mean_bin_size = total_cnt / max_bin
    rest_bin_cnt = max_bin
    rest_sample_cnt = total_cnt
    is_big_np = counts >= mean_bin_size
    rest_bin_cnt -= int(is_big_np.sum())
    rest_sample_cnt -= int(counts[is_big_np].sum())
    is_big = is_big_np.tolist()
    mean_bin_size = rest_sample_cnt / max(rest_bin_cnt, 1)
    upper_bounds = [float("inf")] * max_bin
    lower_bounds = [float("inf")] * max_bin

    bin_cnt = 0
    lower_bounds[0] = dv[0]
    cur_cnt = 0
    for i in range(num_distinct - 1):
        if not is_big[i]:
            rest_sample_cnt -= cn[i]
        cur_cnt += cn[i]
        if (is_big[i] or cur_cnt >= mean_bin_size
                or (is_big[i + 1] and cur_cnt >= max(1.0, mean_bin_size * 0.5))):
            upper_bounds[bin_cnt] = dv[i]
            bin_cnt += 1
            lower_bounds[bin_cnt] = dv[i + 1]
            if bin_cnt >= max_bin - 1:
                break
            cur_cnt = 0
            if not is_big[i]:
                rest_bin_cnt -= 1
                mean_bin_size = rest_sample_cnt / max(rest_bin_cnt, 1)
    bin_cnt += 1
    for i in range(bin_cnt - 1):
        val = _get_double_upper_bound((upper_bounds[i] + lower_bounds[i + 1]) / 2.0)
        if not bin_upper_bound or not _check_double_equal(bin_upper_bound[-1], val):
            bin_upper_bound.append(val)
    bin_upper_bound.append(float("inf"))
    return bin_upper_bound


def find_bin_with_zero_as_one_bin(distinct_values: np.ndarray, counts: np.ndarray,
                                  max_bin: int, total_sample_cnt: int,
                                  min_data_in_bin: int) -> List[float]:
    """bin.cpp FindBinWithZeroAsOneBin: dedicated zero bin in the middle."""
    left_mask = distinct_values <= -K_ZERO_THRESHOLD
    right_mask = distinct_values > K_ZERO_THRESHOLD
    zero_mask = ~left_mask & ~right_mask
    left_cnt_data = int(counts[left_mask].sum())
    cnt_zero = int(counts[zero_mask].sum())
    right_cnt_data = int(counts[right_mask].sum())

    left_idx = np.nonzero(~left_mask)[0]
    left_cnt = int(left_idx[0]) if len(left_idx) else len(distinct_values)

    bin_upper_bound: List[float] = []
    if left_cnt > 0:
        denom = max(total_sample_cnt - cnt_zero, 1)
        left_max_bin = max(1, int(left_cnt_data / denom * (max_bin - 1)))
        bin_upper_bound = greedy_find_bin(distinct_values[:left_cnt], counts[:left_cnt],
                                          left_max_bin, left_cnt_data, min_data_in_bin)
        bin_upper_bound[-1] = -K_ZERO_THRESHOLD

    right_idx = np.nonzero(right_mask)[0]
    if len(right_idx):
        right_start = int(right_idx[0])
        right_max_bin = max_bin - 1 - len(bin_upper_bound)
        check(right_max_bin > 0, "not enough bins for positive values")
        right_bounds = greedy_find_bin(distinct_values[right_start:],
                                       counts[right_start:], right_max_bin,
                                       right_cnt_data, min_data_in_bin)
        bin_upper_bound.append(K_ZERO_THRESHOLD)
        bin_upper_bound.extend(right_bounds)
    else:
        bin_upper_bound.append(float("inf"))
    return bin_upper_bound


class BinMapper:
    """Per-feature value -> bin mapping (bin.h:61-209)."""

    def __init__(self):
        self.num_bin: int = 1
        self.missing_type: int = MissingType.NONE
        self.bin_type: int = BinType.NUMERICAL
        self.is_trivial: bool = True
        self.sparse_rate: float = 0.0
        self.bin_upper_bound: np.ndarray = np.array([np.inf])
        self.min_val: float = 0.0
        self.max_val: float = 0.0
        self.default_bin: int = 0

    # ------------------------------------------------------------------ fit
    def find_bin(self, values: np.ndarray, total_sample_cnt: int, max_bin: int,
                 min_data_in_bin: int = 3, min_split_data: int = 0,
                 use_missing: bool = True,
                 zero_as_missing: bool = False) -> None:
        """BinMapper::FindBin (bin.cpp:210-420), numerical features.

        ``values`` are the *sampled non-trivial* values; ``total_sample_cnt``
        includes rows whose value was 0 (not stored by the sampler).
        """
        values = np.asarray(values, dtype=np.float64)
        na_mask = np.isnan(values)
        na_cnt = int(na_mask.sum())
        values = values[~na_mask]
        num_sample_values = len(values) + na_cnt

        if not use_missing:
            self.missing_type = MissingType.NONE
        elif zero_as_missing:
            self.missing_type = MissingType.ZERO
        else:
            self.missing_type = MissingType.NAN if na_cnt > 0 else MissingType.NONE
        if self.missing_type != MissingType.NAN:
            na_cnt = 0

        self.default_bin = 0
        # rows not captured in `values` and not NaN are implicit zeros
        zero_cnt = int(total_sample_cnt - len(values) - na_cnt)

        values = np.sort(values, kind="stable")
        if len(values):
            # group ulp-adjacent values (CheckDoubleEqualOrdered): a new
            # group starts where v[i] > nextafter(v[i-1], +inf); each
            # group's representative is its LAST (largest) member — a
            # vectorized replay of the reference's sequential merge walk
            new_group = values[1:] > np.nextafter(values[:-1], np.inf)
            last_of_group = np.nonzero(np.append(new_group, True))[0]
            first_of_group = np.concatenate([[0], last_of_group[:-1] + 1])
            dv = values[last_of_group].astype(np.float64)
            gid = np.concatenate([[0], np.cumsum(new_group)])
            ct = np.bincount(gid, minlength=len(dv)).astype(np.int64)
            firsts = values[first_of_group]
            # the implicit-zero entry lands exactly where the sequential
            # walk placed it: before the first strictly-positive group when
            # preceded by a strictly-negative one (inserted even with count
            # 0), at the front/back only when zero_cnt > 0
            pos_groups = np.nonzero(firsts > 0.0)[0]
            j = int(pos_groups[0]) if len(pos_groups) else -1
            if j == 0:
                if zero_cnt > 0:
                    dv = np.insert(dv, 0, 0.0)
                    ct = np.insert(ct, 0, zero_cnt)
            elif j > 0:
                if dv[j - 1] < 0.0:
                    dv = np.insert(dv, j, 0.0)
                    ct = np.insert(ct, j, zero_cnt)
            elif dv[-1] < 0.0 and zero_cnt > 0:
                dv = np.append(dv, 0.0)
                ct = np.append(ct, zero_cnt)
        else:
            dv = np.asarray([0.0], dtype=np.float64)
            ct = np.asarray([zero_cnt], dtype=np.int64)
        self.min_val = float(dv[0]) if len(dv) else 0.0
        self.max_val = float(dv[-1]) if len(dv) else 0.0

        if self.missing_type == MissingType.ZERO:
            bounds = find_bin_with_zero_as_one_bin(dv, ct, max_bin,
                                                   total_sample_cnt, min_data_in_bin)
            if len(bounds) == 2:
                self.missing_type = MissingType.NONE
        elif self.missing_type == MissingType.NONE:
            bounds = find_bin_with_zero_as_one_bin(dv, ct, max_bin,
                                                   total_sample_cnt, min_data_in_bin)
        else:
            bounds = find_bin_with_zero_as_one_bin(dv, ct, max_bin - 1,
                                                   total_sample_cnt - na_cnt,
                                                   min_data_in_bin)
            bounds.append(float("nan"))
        self.bin_upper_bound = np.asarray(bounds, dtype=np.float64)
        self.num_bin = len(bounds)
        # default (zero) bin index
        self.default_bin = self.value_to_bin(0.0)
        cnt_in_bin = np.zeros(self.num_bin, dtype=np.int64)
        if len(dv):
            # first bin whose upper bound covers the value ("advance
            # while dv > bound"), capped at the last bin — NaN bounds
            # (missing bin) sort last so searchsorted stays valid
            idx = np.minimum(
                np.searchsorted(self.bin_upper_bound, dv, side="left"),
                self.num_bin - 1)
            np.add.at(cnt_in_bin, idx, ct)
        if self.missing_type == MissingType.NAN:
            cnt_in_bin[self.num_bin - 1] = na_cnt
        check(self.num_bin <= max_bin, "num_bin exceeds max_bin")

        # trivial / sparse-rate bookkeeping (bin.cpp tail)
        if self.num_bin <= 1:
            self.is_trivial = True
        else:
            self.is_trivial = False
        if not self.is_trivial and min_split_data > 0:
            if _need_filter(cnt_in_bin, total_sample_cnt, min_split_data):
                self.is_trivial = True
        if not self.is_trivial:
            self.sparse_rate = float(cnt_in_bin[self.default_bin]) / max(total_sample_cnt, 1)
        else:
            self.sparse_rate = 1.0

    # ------------------------------------------------------------- transform
    def value_to_bin(self, value: float) -> int:
        """ValueToBin (bin.h:457-493)."""
        if np.isnan(value):
            if self.missing_type == MissingType.NAN:
                return self.num_bin - 1
            value = 0.0
        n_numeric = self.num_bin - (1 if self.missing_type == MissingType.NAN else 0)
        bounds = self.bin_upper_bound
        lo, hi = 0, n_numeric - 1
        while lo < hi:
            mid = (lo + hi) // 2
            if value <= bounds[mid]:
                hi = mid
            else:
                lo = mid + 1
        return lo

    def values_to_bins(self, values: np.ndarray) -> np.ndarray:
        """Vectorized ValueToBin over a column."""
        values = np.asarray(values, dtype=np.float64)
        has_nan_bin = self.missing_type == MissingType.NAN
        n_numeric = self.num_bin - (1 if has_nan_bin else 0)
        bounds = self.bin_upper_bound[:max(n_numeric - 1, 0)]
        nan_mask = np.isnan(values)
        safe = np.where(nan_mask, 0.0, values)
        bins = np.searchsorted(bounds, safe, side="left").astype(np.int32)
        # searchsorted 'left': first idx where bounds[idx] >= v, i.e. v <= bound
        if has_nan_bin:
            bins = np.where(nan_mask, self.num_bin - 1, bins)
        return bins

    def bin_to_value(self, bin_idx: int) -> float:
        """BinToValue: representative (upper bound) of a bin."""
        return float(self.bin_upper_bound[bin_idx])

    # ----------------------------------------------------------- persistence
    def to_dict(self) -> dict:
        return {
            "num_bin": self.num_bin,
            "missing_type": self.missing_type,
            "bin_type": self.bin_type,
            "is_trivial": self.is_trivial,
            "sparse_rate": self.sparse_rate,
            "bin_upper_bound": self.bin_upper_bound.tolist(),
            "bin_2_categorical": [],
            "min_val": self.min_val,
            "max_val": self.max_val,
            "default_bin": int(self.default_bin),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "BinMapper":
        if int(d["bin_type"]) != BinType.NUMERICAL:
            raise outside_slice("categorical bin mappers",
                                "ROADMAP Queue 1 #4")
        m = cls()
        m.num_bin = int(d["num_bin"])
        m.missing_type = int(d["missing_type"])
        m.is_trivial = bool(d["is_trivial"])
        m.sparse_rate = float(d["sparse_rate"])
        m.bin_upper_bound = np.asarray(d["bin_upper_bound"], dtype=np.float64)
        m.min_val = float(d["min_val"])
        m.max_val = float(d["max_val"])
        m.default_bin = int(d["default_bin"])
        return m


def _need_filter(cnt_in_bin: np.ndarray, total_cnt: int,
                 filter_cnt: int) -> bool:
    """bin.cpp NeedFilter (numerical): no bin boundary leaves >= filter_cnt
    on both sides."""
    sum_left = 0
    for i in range(len(cnt_in_bin) - 1):
        sum_left += int(cnt_in_bin[i])
        if sum_left >= filter_cnt and total_cnt - sum_left >= filter_cnt:
            return False
    return True
