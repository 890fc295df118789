"""Search-space machinery (skopt-compatible, implemented in-house).

The reference depends on ``skopt.space`` for dimension objects, the
normalized [0,1] transform into GP space, and helpers like
``normalize_dimensions`` / ``point_asdict`` (reference
``bask/optimizer.py:7-13,144``, ``bask/searchcv.py:3``). This module
provides the same capability surface without skopt:

* ``Real`` (uniform / log-uniform), ``Integer``, ``Categorical``
  (one-hot) dimensions,
* ``Space`` with ``transform`` / ``inverse_transform`` between original
  points and the normalized GP space (everything in [0,1]),
* ``normalize_dimensions`` accepting the same shorthand tuples/lists.
"""

from __future__ import annotations

import numbers
from typing import List, Sequence

import numpy as np

__all__ = [
    "Real",
    "Integer",
    "Categorical",
    "Dimension",
    "Space",
    "normalize_dimensions",
    "dimensions_aslist",
    "point_asdict",
    "point_aslist",
]


class Dimension:
    name: str | None = None
    transformed_size: int = 1

    def transform(self, values):
        raise NotImplementedError

    def inverse_transform(self, values):
        raise NotImplementedError

    def rvs(self, n_samples, random_state):
        raise NotImplementedError

    def rvs_transformed(self, n_samples, random_state):
        """``transform(rvs(n_samples, random_state))``, with the same draws."""
        return self.transform(self.rvs(n_samples, random_state))


def _check_range(values, low, high, dim):
    """Validate numeric values against the dimension bounds (skopt's
    Normalize raises here too); clip away float noise within tolerance."""
    v = np.asarray(values, dtype=float)
    eps = 1e-8 * max(1.0, abs(low), abs(high))
    if np.any(v < low - eps) or np.any(v > high + eps):
        bad = v[(v < low - eps) | (v > high + eps)]
        raise ValueError(
            f"value(s) {bad[:5]} out of bounds ({low}, {high}) for {dim!r}"
        )
    return np.clip(v, low, high)


class Real(Dimension):
    def __init__(self, low, high, prior="uniform", name=None, transform=None):
        if low >= high:
            raise ValueError("low must be < high")
        self.low = float(low)
        self.high = float(high)
        if prior not in ("uniform", "log-uniform"):
            raise ValueError(f"Unknown prior {prior!r}")
        if prior == "log-uniform" and low <= 0:
            raise ValueError("log-uniform requires positive bounds")
        self.prior = prior
        self.name = name

    def transform(self, values):
        v = _check_range(values, self.low, self.high, self)
        if self.prior == "log-uniform":
            return (np.log(v) - np.log(self.low)) / (
                np.log(self.high) - np.log(self.low)
            )
        return (v - self.low) / (self.high - self.low)

    def inverse_transform(self, values):
        u = np.clip(np.asarray(values, dtype=float), 0.0, 1.0)
        if self.prior == "log-uniform":
            return np.exp(
                np.log(self.low)
                + u * (np.log(self.high) - np.log(self.low))
            )
        return self.low + u * (self.high - self.low)

    def rvs(self, n_samples, random_state):
        u = random_state.uniform(size=n_samples)
        return self.inverse_transform(u)

    @property
    def bounds(self):
        return (self.low, self.high)

    def __repr__(self):
        return f"Real({self.low}, {self.high}, prior={self.prior!r}, name={self.name!r})"


class Integer(Dimension):
    def __init__(self, low, high, prior="uniform", name=None, transform=None):
        if low > high:
            raise ValueError("low must be <= high")
        self.low = int(low)
        self.high = int(high)
        if prior not in ("uniform", "log-uniform"):
            raise ValueError(f"Unknown prior {prior!r}")
        if prior == "log-uniform" and low <= 0:
            raise ValueError("log-uniform requires positive bounds")
        self.prior = prior
        self.name = name

    def transform(self, values):
        v = _check_range(values, self.low, self.high, self)
        if self.high == self.low:
            return np.zeros_like(v)
        if self.prior == "log-uniform":
            return (np.log(v) - np.log(self.low)) / (
                np.log(self.high) - np.log(self.low)
            )
        return (v - self.low) / (self.high - self.low)

    def inverse_transform(self, values):
        u = np.clip(np.asarray(values, dtype=float), 0.0, 1.0)
        if self.prior == "log-uniform" and self.high != self.low:
            x = np.round(
                np.exp(
                    np.log(self.low)
                    + u * (np.log(self.high) - np.log(self.low))
                )
            ).astype(int)
        else:
            x = np.round(self.low + u * (self.high - self.low)).astype(int)
        return np.clip(x, self.low, self.high)

    def rvs(self, n_samples, random_state):
        if self.prior == "log-uniform":
            u = random_state.uniform(size=n_samples)
            return self.inverse_transform(u)
        return random_state.randint(self.low, self.high + 1, size=n_samples)

    @property
    def bounds(self):
        return (self.low, self.high)

    def __repr__(self):
        return f"Integer({self.low}, {self.high}, name={self.name!r})"


class Categorical(Dimension):
    def __init__(self, categories, prior=None, name=None, transform=None):
        self.categories = list(categories)
        self.prior = prior
        self.name = name

    @property
    def transformed_size(self):
        return len(self.categories)

    def transform(self, values):
        idx = np.array([self.categories.index(v) for v in values])
        return np.eye(len(self.categories))[idx]

    def inverse_transform(self, values):
        arr = np.asarray(values, dtype=float)
        if arr.ndim == 1:
            # a 1-D input is a column of n points when the one-hot width
            # is 1 (single category), else a single point's one-hot row
            arr = (
                arr[:, None]
                if len(self.categories) == 1
                else np.atleast_2d(arr)
            )
        idx = np.argmax(arr, axis=1)
        return [self.categories[i] for i in idx]

    def _draw_indices(self, n_samples, random_state):
        return random_state.choice(
            len(self.categories), size=n_samples, p=self.prior
        )

    def rvs(self, n_samples, random_state):
        idx = self._draw_indices(n_samples, random_state)
        return [self.categories[i] for i in idx]

    def rvs_transformed(self, n_samples, random_state):
        # one-hot rows from the drawn indices; a category equal to an
        # earlier one takes that one's column, as ``transform`` gives it
        first = np.array([self.categories.index(c) for c in self.categories])
        idx = first[self._draw_indices(n_samples, random_state)]
        return np.eye(len(self.categories))[idx]

    def __repr__(self):
        return f"Categorical({self.categories}, name={self.name!r})"


def _dimension_from_spec(spec) -> Dimension:
    if isinstance(spec, Dimension):
        return spec
    if isinstance(spec, (tuple, list)):
        if len(spec) == 2 and all(
            isinstance(v, numbers.Integral) for v in spec
        ):
            return Integer(*spec)
        if len(spec) == 2 and all(isinstance(v, numbers.Number) for v in spec):
            return Real(*spec)
        if (
            len(spec) == 3
            and all(isinstance(v, numbers.Number) for v in spec[:2])
            and isinstance(spec[2], str)
        ):
            return Real(spec[0], spec[1], prior=spec[2])
        # list of categories
        return Categorical(list(spec))
    raise ValueError(f"Cannot interpret dimension spec: {spec!r}")


class Space:
    """Collection of dimensions with vectorized (inverse) transforms."""

    def __init__(self, dimensions: Sequence):
        self.dimensions: List[Dimension] = [
            _dimension_from_spec(d) for d in dimensions
        ]

    @property
    def n_dims(self):
        return len(self.dimensions)

    @property
    def transformed_n_dims(self):
        return sum(d.transformed_size for d in self.dimensions)

    @property
    def is_partly_categorical(self):
        return any(isinstance(d, Categorical) for d in self.dimensions)

    @property
    def bounds(self):
        return [
            d.bounds if not isinstance(d, Categorical) else d.categories
            for d in self.dimensions
        ]

    def transform(self, points):
        points = list(points)
        return _stack_columns(
            dim.transform([p[j] for p in points])
            for j, dim in enumerate(self.dimensions)
        )

    def inverse_transform(self, arr):
        arr = np.atleast_2d(np.asarray(arr, dtype=float))
        points = [[] for _ in range(arr.shape[0])]
        off = 0
        for dim in self.dimensions:
            w = dim.transformed_size
            block = arr[:, off : off + w]
            vals = dim.inverse_transform(block if w > 1 else block[:, 0])
            for i, v in enumerate(vals):
                if isinstance(v, np.generic):
                    v = v.item()
                points[i].append(v)
            off += w
        return points

    def rvs(self, n_samples=1, random_state=None):
        if not isinstance(random_state, np.random.RandomState):
            random_state = np.random.RandomState(random_state)
        cols = [d.rvs(n_samples, random_state) for d in self.dimensions]
        return [
            [
                c[i].item() if isinstance(c[i], np.generic) else c[i]
                for c in cols
            ]
            for i in range(n_samples)
        ]

    def rvs_transformed(self, n_samples=1, random_state=None):
        """``transform(rvs(n_samples, random_state))`` as one float64
        ``(n_samples, transformed_n_dims)`` array: the same draws in the
        same order, each dimension's column drawn and transformed as an
        array, with no per-point object."""
        if not isinstance(random_state, np.random.RandomState):
            random_state = np.random.RandomState(random_state)
        return _stack_columns(
            dim.rvs_transformed(n_samples, random_state)
            for dim in self.dimensions
        )

    def __repr__(self):
        return f"Space({self.dimensions})"


def _stack_columns(blocks):
    """Join per-dimension transformed blocks ((n,) or (n, w)) into (n, D)."""
    return np.concatenate(
        [t[:, None] if t.ndim == 1 else t for t in blocks], axis=1
    )


def normalize_dimensions(dimensions) -> Space:
    """Build a Space whose transform maps into [0,1]^transformed_n_dims
    (the convention the GP operates in; analogue of skopt's
    ``normalize_dimensions``, used at reference ``bask/optimizer.py:144``)."""
    return Space(dimensions)


def dimensions_aslist(search_space: dict):
    """Dimensions of a dict search space ordered by parameter name."""
    return [search_space[k] for k in sorted(search_space.keys())]


def point_asdict(search_space: dict, point_as_list):
    return {
        k: v for k, v in zip(sorted(search_space.keys()), point_as_list)
    }


def point_aslist(search_space: dict, point_as_dict):
    return [point_as_dict[k] for k in sorted(search_space.keys())]
