"""Minimal unit system for dspeed_tpu_torch.

The reference implementation uses :mod:`pint` for its unit algebra
(``dspeed/units.py:1-7`` and throughout ``processing_chain.py``). pint is not
a dependency of this package; all unit work happens at *build time* (chain
compilation), never on device, so a small, exact implementation is preferable
to a heavyweight registry. This module provides the pint API surface the
chain compiler needs:

- :class:`Unit` — a scale factor onto SI base dimensions plus a display label
- :class:`Quantity` — (magnitude, Unit) with arithmetic, comparison,
  ``.to()`` conversion, and ``float()`` of dimensionless values
- :class:`UnitRegistry` — name lookup (``"ns" in ureg``, ``ureg("us")``),
  compatibility checks, and the pi-theorem exponent search used to convert
  unitted scalars into a coordinate grid's sample units (the reference relies
  on ``pint.pi_theorem`` for this at ``processing_chain.py:1759-1766``, e.g.
  ``6.25*GHz`` against a 16 ns grid period resolving to 100 samples).

Unknown unit strings (``"ADC"``, ``"ADC/sample"``) are intentionally *not*
registered: the reference treats any string not found in pint as an opaque
label, and the chain compiler here does the same.
"""

from __future__ import annotations

import re
from fractions import Fraction
from numbers import Real

__all__ = [
    "Unit",
    "Quantity",
    "UnitRegistry",
    "unit_registry",
    "ureg",
    "DimensionalityError",
]

# SI base dimensions: time, length, mass, current, temperature, amount,
# luminous intensity
_NDIM = 7
_ZERO_DIMS = (Fraction(0),) * _NDIM


class DimensionalityError(ValueError):
    """Raised when an operation requires compatible dimensions and they differ."""


def _dim(index: int, power: int = 1) -> tuple[Fraction, ...]:
    d = [Fraction(0)] * _NDIM
    d[index] = Fraction(power)
    return tuple(d)


_TIME = _dim(0)
_FREQ = tuple(-x for x in _TIME)
_LENGTH = _dim(1)
_MASS = _dim(2)
_CURRENT = _dim(3)
_TEMPERATURE = _dim(4)
_AMOUNT = _dim(5)
_LUMINOUS = _dim(6)


def _dims_add(a, b):
    return tuple(x + y for x, y in zip(a, b))


def _dims_sub(a, b):
    return tuple(x - y for x, y in zip(a, b))


def _dims_mul(a, k: Fraction):
    return tuple(x * k for x in a)


class Unit:
    """A unit: a scale factor to SI base units, a dimension vector, a label."""

    __slots__ = ("scale", "dims", "label")

    def __new__(cls, scale=1.0, dims=_ZERO_DIMS, label=""):
        # Copy/parse constructors, matching pint.Unit(str) usage in the
        # reference (processing_chain.py:1381-1382)
        if isinstance(scale, Unit):
            return scale
        if isinstance(scale, Quantity):
            if scale.m != 1:
                raise ValueError(f"cannot make a Unit from {scale}")
            return scale.u
        if isinstance(scale, str):
            q = unit_registry.parse_expression(scale)
            if q.m != 1:
                raise ValueError(f"cannot make a Unit from {scale}")
            return q.u
        self = object.__new__(cls)
        # Fraction scales keep unit conversion ratios exact (ns -> us == 1000,
        # not 999.9999...); float scales are accepted for irrational factors.
        self.scale = scale if isinstance(scale, Fraction) else Fraction(scale)
        self.dims = tuple(dims)
        self.label = label
        return self

    @property
    def dimensionless(self) -> bool:
        return self.dims == _ZERO_DIMS

    def __eq__(self, other) -> bool:
        if isinstance(other, str):
            try:
                other = Unit(other)
            except (ValueError, KeyError):
                return NotImplemented
        if isinstance(other, Quantity):
            return other.__eq__(1 * self)
        if not isinstance(other, Unit):
            return NotImplemented
        return self.dims == other.dims and self.scale == other.scale

    def __hash__(self):
        return hash((self.scale, self.dims))

    def __mul__(self, other):
        if isinstance(other, Real):
            return Quantity(other, self)
        if isinstance(other, Unit):
            return Quantity(1, _combine(self, other, +1))
        if isinstance(other, Quantity):
            return Quantity(other.m, _combine(self, other.u, +1))
        return NotImplemented

    __rmul__ = __mul__

    def __truediv__(self, other):
        if isinstance(other, Real):
            return Quantity(1.0 / other, self)
        if isinstance(other, Unit):
            return Quantity(1, _combine(self, other, -1))
        if isinstance(other, Quantity):
            return Quantity(1.0 / other.m, _combine(self, other.u, -1))
        return NotImplemented

    def __rtruediv__(self, other):
        if isinstance(other, Real):
            return Quantity(other, self**-1)
        return NotImplemented

    def __pow__(self, k):
        frac = Fraction(k).limit_denominator(1000)
        label = self.label
        if label and k != 1:
            label = f"{label}**{k}"
        if frac.denominator == 1:
            scale = self.scale ** frac.numerator
        else:
            scale = Fraction(float(self.scale) ** float(frac))
        return Unit(scale, _dims_mul(self.dims, frac), label)

    def __format__(self, spec) -> str:
        # pint short ("~", "~P") formats reduce to the symbol label
        return self.label

    def __str__(self) -> str:
        return self.label

    def __repr__(self) -> str:
        return f"Unit({self.label!r})"


def _combine(a: Unit, b: Unit, sign: int) -> Unit:
    dims = _dims_add(a.dims, b.dims) if sign > 0 else _dims_sub(a.dims, b.dims)
    scale = a.scale * b.scale if sign > 0 else a.scale / b.scale
    if dims == _ZERO_DIMS and scale == 1.0:
        return dimensionless
    if not a.label:
        label = b.label if sign > 0 else (f"1/{b.label}" if b.label else "")
    elif not b.label:
        label = a.label
    else:
        label = f"{a.label}*{b.label}" if sign > 0 else f"{a.label}/{b.label}"
    return Unit(scale, dims, label)


class Quantity:
    """A magnitude with a :class:`Unit`, supporting pint-style arithmetic."""

    __slots__ = ("m", "u")

    def __new__(cls, m=1, u=None):
        if isinstance(m, str) and u is None:
            return unit_registry.parse_expression(m)
        if isinstance(m, Quantity):
            if u is not None:
                return m.to(u)
            return m
        self = object.__new__(cls)
        if u is None:
            u = dimensionless
        elif isinstance(u, str):
            u = Unit(u)
        elif isinstance(u, Quantity):
            self.m = m * u.m
            self.u = u.u
            return self
        self.m = m
        self.u = u
        return self

    # pint aliases
    @property
    def magnitude(self):
        return self.m

    @property
    def units(self):
        return self.u

    @property
    def dimensionless(self) -> bool:
        return self.u.dimensionless

    def to(self, target) -> Quantity:
        if isinstance(target, str):
            target = Unit(target)
        elif isinstance(target, Quantity):
            target = target.u
        if target.dims != self.u.dims:
            raise DimensionalityError(
                f"cannot convert {self} to {target.label or 'dimensionless'}"
            )
        return Quantity(self.m * float(self.u.scale / target.scale), target)

    def _base_value(self) -> float:
        return self.m * float(self.u.scale)

    def __float__(self) -> float:
        if not self.u.dimensionless:
            raise DimensionalityError(f"{self} is not dimensionless")
        return float(self.m) * float(self.u.scale)

    def __int__(self) -> int:
        return int(float(self))

    def __add__(self, other):
        if isinstance(other, Quantity):
            if other.u.dims != self.u.dims:
                raise DimensionalityError(f"cannot add {self} and {other}")
            return Quantity(self.m + other.m * float(other.u.scale / self.u.scale), self.u)
        if isinstance(other, Real):
            if not self.u.dimensionless:
                raise DimensionalityError(f"cannot add {self} and {other}")
            return Quantity(float(self) + other)
        return NotImplemented

    __radd__ = __add__

    def __sub__(self, other):
        return self._sub(other)

    def _sub(self, other):
        if isinstance(other, Quantity):
            if other.u.dims != self.u.dims:
                raise DimensionalityError(f"cannot subtract {other} from {self}")
            return Quantity(self.m - other.m * float(other.u.scale / self.u.scale), self.u)
        if isinstance(other, Real):
            if not self.u.dimensionless:
                raise DimensionalityError(f"cannot subtract {other} from {self}")
            return Quantity(float(self) - other)
        return NotImplemented

    def __rsub__(self, other):
        r = self._sub(other)
        if r is NotImplemented:
            return r
        return Quantity(-r.m, r.u)

    def __neg__(self):
        return Quantity(-self.m, self.u)

    def __mul__(self, other):
        if isinstance(other, Quantity):
            return Quantity(self.m * other.m, _combine(self.u, other.u, +1))
        if isinstance(other, Unit):
            return Quantity(self.m, _combine(self.u, other, +1))
        if isinstance(other, Real):
            return Quantity(self.m * other, self.u)
        return NotImplemented

    __rmul__ = __mul__

    def __truediv__(self, other):
        if isinstance(other, Quantity):
            return Quantity(self.m / other.m, _combine(self.u, other.u, -1))
        if isinstance(other, Unit):
            return Quantity(self.m, _combine(self.u, other, -1))
        if isinstance(other, Real):
            return Quantity(self.m / other, self.u)
        return NotImplemented

    def __rtruediv__(self, other):
        if isinstance(other, Real):
            return Quantity(other / self.m, _unit_inv(self.u))
        return NotImplemented

    def __floordiv__(self, other):
        q = self.__truediv__(other)
        if q is NotImplemented:
            return q
        if not q.u.dimensionless:
            raise DimensionalityError(f"cannot floor-divide {self} by {other}")
        import math

        return Quantity(math.floor(float(q)))

    def __pow__(self, k):
        return Quantity(self.m ** float(k), self.u**k)

    def _cmp_value_pair(self, other):
        if isinstance(other, Quantity):
            if other.u.dims != self.u.dims:
                raise DimensionalityError(f"cannot compare {self} and {other}")
            # compare via the conversion ratio rather than absolute SI values
            # to avoid spurious float rounding (2 us must equal 2000 ns)
            return self.m, other.m * float(other.u.scale / self.u.scale)
        if isinstance(other, Unit):
            return self._cmp_value_pair(Quantity(1, other))
        if isinstance(other, Real):
            if not self.u.dimensionless:
                raise DimensionalityError(f"cannot compare {self} and {other}")
            return self._base_value(), float(other)
        return None

    def __eq__(self, other):
        if isinstance(other, Real) and not self.u.dimensionless:
            return False
        try:
            pair = self._cmp_value_pair(other)
        except DimensionalityError:
            return False
        if pair is None:
            return NotImplemented
        return pair[0] == pair[1]

    def __hash__(self):
        return hash((float(self._base_value()), self.u.dims))

    def __lt__(self, other):
        a, b = self._cmp_value_pair(other)
        return a < b

    def __le__(self, other):
        a, b = self._cmp_value_pair(other)
        return a <= b

    def __gt__(self, other):
        a, b = self._cmp_value_pair(other)
        return a > b

    def __ge__(self, other):
        a, b = self._cmp_value_pair(other)
        return a >= b

    def __format__(self, spec) -> str:
        return str(self)

    def __str__(self) -> str:
        lbl = self.u.label
        return f"{self.m} {lbl}".strip() if lbl else str(self.m)

    def __repr__(self) -> str:
        return f"Quantity({self.m!r}, {self.u.label!r})"


def _neg(x):
    return -x


def _unit_inv(u: Unit) -> Unit:
    return u**-1


dimensionless = Unit(1.0, _ZERO_DIMS, "")


class UnitRegistry:
    """Registry of named units with a pint-compatible query surface."""

    def __init__(self) -> None:
        self._units: dict[str, Unit] = {}
        self.dimensionless = dimensionless
        self._fill_defaults()

    def define(self, names: list[str], scale, dims, label: str | None = None):
        u = Unit(scale, dims, label if label is not None else names[0])
        for n in names:
            self._units[n] = u
        return u

    def _fill_defaults(self) -> None:
        d = self.define
        F = Fraction
        # time
        d(["s", "second", "seconds", "sec"], F(1), _TIME)
        d(["ms", "millisecond", "milliseconds"], F(1, 10**3), _TIME)
        d(["us", "microsecond", "microseconds", "µs", "μs"], F(1, 10**6), _TIME, "us")
        d(["ns", "nanosecond", "nanoseconds"], F(1, 10**9), _TIME)
        d(["ps", "picosecond", "picoseconds"], F(1, 10**12), _TIME)
        d(["fs", "femtosecond", "femtoseconds"], F(1, 10**15), _TIME)
        d(["minute", "minutes"], F(60), _TIME)
        d(["hour", "hours", "hr"], F(3600), _TIME)
        d(["day", "days"], F(86400), _TIME)
        # frequency
        d(["Hz", "hertz"], F(1), _FREQ)
        d(["kHz", "kilohertz"], F(10**3), _FREQ)
        d(["MHz", "megahertz"], F(10**6), _FREQ)
        d(["GHz", "gigahertz"], F(10**9), _FREQ)
        d(["THz", "terahertz"], F(10**12), _FREQ)
        # length
        d(["m", "meter", "meters", "metre"], F(1), _LENGTH)
        d(["cm", "centimeter", "centimeters"], F(1, 100), _LENGTH)
        d(["mm", "millimeter", "millimeters"], F(1, 10**3), _LENGTH)
        d(["um", "micrometer", "micrometers"], F(1, 10**6), _LENGTH, "um")
        d(["nm", "nanometer", "nanometers"], F(1, 10**9), _LENGTH)
        d(["km", "kilometer", "kilometers"], F(10**3), _LENGTH)
        # mass
        d(["kg", "kilogram", "kilograms"], F(1), _MASS)
        d(["g", "gram", "grams"], F(1, 10**3), _MASS)
        d(["mg", "milligram", "milligrams"], F(1, 10**6), _MASS)
        # current
        d(["A", "ampere", "amperes", "amp"], F(1), _CURRENT)
        d(["mA", "milliampere"], F(1, 10**3), _CURRENT)
        # temperature (absolute scales only)
        d(["K", "kelvin"], F(1), _TEMPERATURE)
        # amount / luminosity
        d(["mol", "mole"], F(1), _AMOUNT)
        d(["cd", "candela"], F(1), _LUMINOUS)
        # voltage: kg*m^2/(A*s^3)
        vdims = _dims_sub(
            _dims_add(_MASS, _dims_mul(_LENGTH, Fraction(2))),
            _dims_add(_CURRENT, _dims_mul(_TIME, Fraction(3))),
        )
        d(["V", "volt", "volts"], F(1), vdims)
        d(["mV", "millivolt", "millivolts"], F(1, 10**3), vdims)
        d(["uV", "microvolt", "microvolts"], F(1, 10**6), vdims, "uV")
        d(["kV", "kilovolt", "kilovolts"], F(10**3), vdims)
        # energy: kg*m^2/s^2
        edims = _dims_sub(
            _dims_add(_MASS, _dims_mul(_LENGTH, Fraction(2))),
            _dims_mul(_TIME, Fraction(2)),
        )
        d(["J", "joule", "joules"], F(1), edims)
        _EV = 1.602176634e-19
        d(["eV", "electronvolt"], _EV, edims)
        d(["keV", "kiloelectronvolt"], 1e3 * _EV, edims)
        d(["MeV", "megaelectronvolt"], 1e6 * _EV, edims)
        # charge: A*s
        cdims = _dims_add(_CURRENT, _TIME)
        d(["C", "coulomb", "coulombs"], F(1), cdims)
        d(["pC", "picocoulomb"], F(1, 10**12), cdims)

    # --- pint API surface -------------------------------------------------
    def __contains__(self, name) -> bool:
        if isinstance(name, (Unit, Quantity)):
            return True
        if not isinstance(name, str):
            return False
        if name in self._units:
            return True
        try:
            self.parse_expression(name)
            return True
        except (KeyError, ValueError):
            return False

    def __call__(self, expr: str) -> Quantity:
        return self.parse_expression(expr)

    def __getattr__(self, name: str):
        try:
            return Quantity(1, self._units[name])
        except KeyError:
            raise AttributeError(name) from None

    def Quantity(self, value=1, unit=None) -> Quantity:  # noqa: N802
        if isinstance(value, str) and unit is None:
            return self.parse_expression(value)
        return Quantity(value, unit)

    def Unit(self, value) -> Unit:  # noqa: N802
        return Unit(value)

    def parse_expression(self, expr: str) -> Quantity:
        """Parse strings like ``"ns"``, ``"16 ns"``, ``"ADC/sample"``.

        Supports an optional leading magnitude and ``*``, ``/``, ``**`` unit
        composition. Raises ``KeyError`` for unknown unit names (so callers
        can treat e.g. ``"ADC"`` as an opaque label, like the reference does
        when a string is not found in pint).
        """
        expr = expr.strip()
        m = re.match(r"^([+-]?\d+(?:\.\d*)?(?:[eE][+-]?\d+)?)\s*", expr)
        mag = 1.0
        if m:
            mag = float(m.group(1))
            expr = expr[m.end() :]
        if not expr:
            return Quantity(mag)
        q = Quantity(mag)
        for sign, name, power in _tokenize_units(expr):
            if name not in self._units:
                raise KeyError(f"unknown unit {name!r}")
            u = self._units[name] ** power
            q = q * u if sign > 0 else q / u
        return q

    def is_compatible_with(self, a, b) -> bool:
        try:
            da = _dims_of(a)
            db = _dims_of(b)
        except (KeyError, ValueError):
            return False
        return da == db

    def pi_exponent(self, period, param) -> Fraction | None:
        """Find rational ``k`` with ``dims(param) + k*dims(period) == 0``.

        This is the single-pi-group case of pint's ``pi_theorem`` that the
        reference uses to convert unitted scalars into grid sample counts
        (``processing_chain.py:1757-1766``). Returns ``None`` if no such
        exponent exists.
        """
        dp = _dims_of(period)
        dx = _dims_of(param)
        if dp == _ZERO_DIMS:
            return None
        k = None
        for p, x in zip(dp, dx):
            if p == 0:
                if x != 0:
                    return None
                continue
            kk = -x / p
            if k is None:
                k = kk
            elif k != kk:
                return None
        return k


def _dims_of(x) -> tuple:
    if isinstance(x, Quantity):
        return x.u.dims
    if isinstance(x, Unit):
        return x.dims
    if isinstance(x, str):
        return unit_registry.parse_expression(x).u.dims
    if isinstance(x, Real):
        return _ZERO_DIMS
    raise ValueError(f"cannot get dimensions of {x!r}")


def _tokenize_units(expr: str):
    """Yield (sign, unit_name, power) triples from a unit expression.

    Exponents require an explicit ``**`` or ``^`` (pint semantics): ``s**2``
    is seconds squared, while ``s2`` is NOT a unit (it may be a variable
    name).
    """
    tokens = re.findall(
        r"([*/])?\s*([A-Za-zµμ]+)\s*(?:(?:\*\*|\^)\s*([+-]?\d+))?", expr
    )
    consumed = re.sub(
        r"[\s]|[*/]|\^|[A-Za-zµμ]+(?:\s*(?:\*\*|\^)\s*[+-]?\d+)?", "", expr
    )
    if consumed:
        raise ValueError(f"cannot parse unit expression {expr!r}")
    first = True
    for op, name, power in tokens:
        if not name:
            continue
        sign = -1 if op == "/" else 1
        if first and op == "/":
            sign = -1
        first = False
        yield sign, name, int(power) if power else 1


unit_registry = UnitRegistry()
ureg = unit_registry
