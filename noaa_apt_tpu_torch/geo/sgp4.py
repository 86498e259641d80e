"""SGP4 orbit propagation (near-earth), TLE parsing, and TEME ->
geodetic transforms.

The reference delegates to the satellite-rs crate; this is an
independent implementation of the standard SGP4 model (Vallado,
"Revisiting Spacetrack Report #3", AIAA 2006-6753; WGS-72 constants),
restricted to the near-earth case — NOAA POES orbits (~101 min period)
never trigger deep-space (SDP4) terms.  Validated against the
reference's embedded `predict` regression table (``geo.rs:198-251``)
at its stated per-case tolerances.

A copy of ``noaa_apt_tpu/geo/sgp4.py`` (the port imports nothing of
the JAX package); the tests hold the two equal.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from datetime import datetime, timezone

from .. import err

# WGS-72 gravity model (the constants satellite-rs/predict use).
_MU = 398600.8  # km^3 / s^2
RADIUS_EARTH_KM = 6378.135
_XKE = 60.0 / math.sqrt(RADIUS_EARTH_KM**3 / _MU)
_J2 = 0.001082616
_J3 = -0.00000253881
_J4 = -0.00000165597
_J3OJ2 = _J3 / _J2
_X2O3 = 2.0 / 3.0
_TWOPI = 2.0 * math.pi
_DEG2RAD = math.pi / 180.0
# WGS-72 ellipsoid flattening for geodetic conversion.
_FLATTENING = 1.0 / 298.26


@dataclass
class Satrec:
    """Parsed TLE + SGP4 initialization state."""

    name: str
    satnum: str
    epoch_jd: float  # Julian date (UTC) of TLE epoch
    bstar: float
    inclo: float  # rad
    nodeo: float  # rad
    ecco: float
    argpo: float  # rad
    mo: float  # rad
    no_kozai: float  # rad/min
    _init: dict = field(default_factory=dict, repr=False)

    def __post_init__(self):
        self._init = _sgp4init(self)


def _days_to_jd(year: int, days: float) -> float:
    """Julian date from TLE epoch year + fractional day-of-year."""
    jan1 = datetime(year, 1, 1, tzinfo=timezone.utc)
    jd_jan1 = _datetime_to_jd(jan1)
    return jd_jan1 + (days - 1.0)


def _datetime_to_jd(t: datetime) -> float:
    t = t.astimezone(timezone.utc)
    year, month, day = t.year, t.month, t.day
    frac = (t.hour + (t.minute + (t.second + t.microsecond / 1e6) / 60.0) / 60.0) / 24.0
    jdn = (
        367 * year
        - (7 * (year + (month + 9) // 12)) // 4
        + (275 * month) // 9
        + day
        + 1721013.5
    )
    return jdn + frac


def _parse_float_tle(s: str) -> float:
    """Parse TLE implied-decimal exponent fields like ' 22730-4'
    (meaning 0.22730e-4) or '-11606-4' or '00000+0'."""
    s = s.strip()
    if not s:
        return 0.0
    sign = 1.0
    if s[0] in "+-":
        if s[0] == "-":
            sign = -1.0
        s = s[1:]
    exp = 0
    for i in range(len(s) - 1, 0, -1):
        if s[i] in "+-":
            exp = int(s[i:])
            s = s[:i]
            break
    return sign * float(f"0.{s}") * 10.0**exp


def parse_tle(text: str) -> list[Satrec]:
    """Parse a multi-satellite TLE file (name + 2 lines per sat)."""
    lines = [ln.rstrip() for ln in text.splitlines() if ln.strip()]
    sats = []
    i = 0
    while i < len(lines):
        if lines[i].startswith("1 ") and i + 1 < len(lines) and lines[i + 1].startswith("2 "):
            name = lines[i - 1].strip() if i > 0 and not lines[i - 1].startswith(("1 ", "2 ")) else ""
            l1, l2 = lines[i], lines[i + 1]
            try:
                sats.append(_parse_lines(name, l1, l2))
            except (ValueError, IndexError) as e:
                raise err.InternalError(f"Malformed TLE for {name!r}: {e}")
            i += 2
        else:
            i += 1
    return sats


def _parse_lines(name: str, l1: str, l2: str) -> Satrec:
    satnum = l1[2:7].strip()
    epoch_year = int(l1[18:20])
    epoch_year += 1900 if epoch_year >= 57 else 2000
    epoch_days = float(l1[20:32])
    bstar = _parse_float_tle(l1[53:61])
    inclo = float(l2[8:16]) * _DEG2RAD
    nodeo = float(l2[17:25]) * _DEG2RAD
    ecco = float("0." + l2[26:33].strip())
    argpo = float(l2[34:42]) * _DEG2RAD
    mo = float(l2[43:51]) * _DEG2RAD
    no_kozai = float(l2[52:63]) * _TWOPI / 1440.0  # rev/day -> rad/min
    return Satrec(
        name=name,
        satnum=satnum,
        epoch_jd=_days_to_jd(epoch_year, epoch_days),
        bstar=bstar,
        inclo=inclo,
        nodeo=nodeo,
        ecco=ecco,
        argpo=argpo,
        mo=mo,
        no_kozai=no_kozai,
    )


def find_satellite(sats: list[Satrec], name: str) -> Satrec:
    for s in sats:
        if s.name == name:
            return s
    raise err.InternalError(f'Satellite "{name}" not found in TLE')


# ---------------------------------------------------------------------------
# SGP4 near-earth initialization + propagation.


def _sgp4init(s: Satrec) -> dict:
    eccsq = s.ecco * s.ecco
    omeosq = 1.0 - eccsq
    rteosq = math.sqrt(omeosq)
    cosio = math.cos(s.inclo)
    cosio2 = cosio * cosio
    sinio = math.sin(s.inclo)

    # Un-kozai the mean motion.
    ak = (_XKE / s.no_kozai) ** _X2O3
    d1 = 0.75 * _J2 * (3.0 * cosio2 - 1.0) / (rteosq * omeosq)
    delp = d1 / (ak * ak)
    adel = ak * (1.0 - delp * delp - delp * (1.0 / 3.0 + 134.0 * delp * delp / 81.0))
    delp = d1 / (adel * adel)
    no_unkozai = s.no_kozai / (1.0 + delp)

    # Deep-space guard: the published SGP4 switches to the SDP4 model
    # (lunar/solar + resonance terms) when the orbital period reaches
    # 225 min (Vallado AIAA 2006-6753, sgp4init `method = 'd'`).  This
    # implementation covers only the near-earth case the reference's
    # NOAA passes ever hit (satellite-rs ships SDP4; geo.rs:198-251
    # exercises near-earth only) — propagating a deep-space TLE here
    # would silently return wrong positions, so refuse instead.
    if no_unkozai <= 0.0 or _TWOPI / no_unkozai >= 225.0:
        raise err.FeatureNotAvailableError(
            f"TLE for {s.name or s.satnum!r} has an orbital period of "
            f"{_TWOPI / no_unkozai if no_unkozai > 0 else float('inf'):.1f} min "
            "(>= 225 min): a deep-space orbit requiring SDP4, which this "
            "near-earth SGP4 implementation does not model. Map overlay "
            "supports near-earth (e.g. NOAA POES) satellites only."
        )

    ao = (_XKE / no_unkozai) ** _X2O3
    po = ao * omeosq
    con42 = 1.0 - 5.0 * cosio2
    con41 = -con42 - 2.0 * cosio2
    posq = po * po
    rp = ao * (1.0 - s.ecco)

    ss = 78.0 / RADIUS_EARTH_KM + 1.0
    qzms2t = ((120.0 - 78.0) / RADIUS_EARTH_KM) ** 4
    sfour = ss
    qzms24 = qzms2t
    perige = (rp - 1.0) * RADIUS_EARTH_KM
    if perige < 156.0:
        sfour = perige - 78.0
        if perige < 98.0:
            sfour = 20.0
        qzms24 = ((120.0 - sfour) / RADIUS_EARTH_KM) ** 4
        sfour = sfour / RADIUS_EARTH_KM + 1.0

    pinvsq = 1.0 / posq
    tsi = 1.0 / (ao - sfour)
    eta = ao * s.ecco * tsi
    etasq = eta * eta
    eeta = s.ecco * eta
    psisq = abs(1.0 - etasq)
    coef = qzms24 * tsi**4
    coef1 = coef / psisq**3.5
    cc2 = (
        coef1
        * no_unkozai
        * (
            ao * (1.0 + 1.5 * etasq + eeta * (4.0 + etasq))
            + 0.375 * _J2 * tsi / psisq * con41 * (8.0 + 3.0 * etasq * (8.0 + etasq))
        )
    )
    cc1 = s.bstar * cc2
    cc3 = 0.0
    if s.ecco > 1.0e-4:
        cc3 = -2.0 * coef * tsi * _J3OJ2 * no_unkozai * sinio / s.ecco
    x1mth2 = 1.0 - cosio2
    cc4 = (
        2.0
        * no_unkozai
        * coef1
        * ao
        * omeosq
        * (
            eta * (2.0 + 0.5 * etasq)
            + s.ecco * (0.5 + 2.0 * etasq)
            - _J2
            * tsi
            / (ao * psisq)
            * (
                -3.0 * con41 * (1.0 - 2.0 * eeta + etasq * (1.5 - 0.5 * eeta))
                + 0.75
                * x1mth2
                * (2.0 * etasq - eeta * (1.0 + etasq))
                * math.cos(2.0 * s.argpo)
            )
        )
    )
    cc5 = 2.0 * coef1 * ao * omeosq * (1.0 + 2.75 * (etasq + eeta) + eeta * etasq)
    cosio4 = cosio2 * cosio2
    temp1 = 1.5 * _J2 * pinvsq * no_unkozai
    temp2 = 0.5 * temp1 * _J2 * pinvsq
    temp3 = -0.46875 * _J4 * pinvsq * pinvsq * no_unkozai
    mdot = (
        no_unkozai
        + 0.5 * temp1 * rteosq * con41
        + 0.0625 * temp2 * rteosq * (13.0 - 78.0 * cosio2 + 137.0 * cosio4)
    )
    argpdot = (
        -0.5 * temp1 * con42
        + 0.0625 * temp2 * (7.0 - 114.0 * cosio2 + 395.0 * cosio4)
        + temp3 * (3.0 - 36.0 * cosio2 + 49.0 * cosio4)
    )
    xhdot1 = -temp1 * cosio
    nodedot = xhdot1 + (
        0.5 * temp2 * (4.0 - 19.0 * cosio2) + 2.0 * temp3 * (3.0 - 7.0 * cosio2)
    ) * cosio
    omgcof = s.bstar * cc3 * math.cos(s.argpo)
    xmcof = 0.0
    if s.ecco > 1.0e-4:
        xmcof = -_X2O3 * coef * s.bstar / eeta
    nodecf = 3.5 * omeosq * xhdot1 * cc1
    t2cof = 1.5 * cc1
    if abs(cosio + 1.0) > 1.5e-12:
        xlcof = -0.25 * _J3OJ2 * sinio * (3.0 + 5.0 * cosio) / (1.0 + cosio)
    else:
        xlcof = -0.25 * _J3OJ2 * sinio * (3.0 + 5.0 * cosio) / 1.5e-12
    aycof = -0.5 * _J3OJ2 * sinio
    delmo = (1.0 + eta * math.cos(s.mo)) ** 3
    sinmao = math.sin(s.mo)
    x7thm1 = 7.0 * cosio2 - 1.0

    isimp = rp < 220.0 / RADIUS_EARTH_KM + 1.0
    d2 = d3 = d4 = t3cof = t4cof = t5cof = 0.0
    if not isimp:
        cc1sq = cc1 * cc1
        d2 = 4.0 * ao * tsi * cc1sq
        temp = d2 * tsi * cc1 / 3.0
        d3 = (17.0 * ao + sfour) * temp
        d4 = 0.5 * temp * ao * tsi * (221.0 * ao + 31.0 * sfour) * cc1
        t3cof = d2 + 2.0 * cc1sq
        t4cof = 0.25 * (3.0 * d3 + cc1 * (12.0 * d2 + 10.0 * cc1sq))
        t5cof = 0.2 * (
            3.0 * d4 + 12.0 * cc1 * d3 + 6.0 * d2 * d2 + 15.0 * cc1sq * (2.0 * d2 + cc1sq)
        )

    return dict(
        no_unkozai=no_unkozai, ao=ao, con41=con41, cc1=cc1, cc4=cc4, cc5=cc5,
        cosio=cosio, sinio=sinio, x1mth2=x1mth2, x7thm1=x7thm1,
        mdot=mdot, argpdot=argpdot, nodedot=nodedot, nodecf=nodecf,
        omgcof=omgcof, xmcof=xmcof, eta=eta, delmo=delmo, sinmao=sinmao,
        t2cof=t2cof, t3cof=t3cof, t4cof=t4cof, t5cof=t5cof,
        d2=d2, d3=d3, d4=d4, isimp=isimp, xlcof=xlcof, aycof=aycof,
    )


def sgp4(s: Satrec, tsince: float) -> tuple[float, float, float]:
    """Propagate ``tsince`` minutes past epoch; returns TEME position
    (km)."""
    i = s._init
    no = i["no_unkozai"]

    xmdf = s.mo + i["mdot"] * tsince
    argpdf = s.argpo + i["argpdot"] * tsince
    nodedf = s.nodeo + i["nodedot"] * tsince
    argpm = argpdf
    mm = xmdf
    t2 = tsince * tsince
    nodem = nodedf + i["nodecf"] * t2
    tempa = 1.0 - i["cc1"] * tsince
    tempe = s.bstar * i["cc4"] * tsince
    templ = i["t2cof"] * t2

    if not i["isimp"]:
        delomg = i["omgcof"] * tsince
        delmtemp = 1.0 + i["eta"] * math.cos(xmdf)
        delm = i["xmcof"] * (delmtemp**3 - i["delmo"])
        temp = delomg + delm
        mm = xmdf + temp
        argpm = argpdf - temp
        t3 = t2 * tsince
        t4 = t3 * tsince
        tempa = tempa - i["d2"] * t2 - i["d3"] * t3 - i["d4"] * t4
        tempe = tempe + s.bstar * i["cc5"] * (math.sin(mm) - i["sinmao"])
        templ = templ + i["t3cof"] * t3 + t4 * (i["t4cof"] + tsince * i["t5cof"])

    em = s.ecco - tempe
    am = i["ao"] * tempa * tempa
    nm = _XKE / am**1.5
    if em < 1.0e-6:
        em = 1.0e-6
    mm = mm + no * templ
    xlm = mm + argpm + nodem
    nodem = math.fmod(nodem, _TWOPI)
    argpm = math.fmod(argpm, _TWOPI)
    xlm = math.fmod(xlm, _TWOPI)
    mm = math.fmod(xlm - argpm - nodem, _TWOPI)

    # Long-period periodics.
    axnl = em * math.cos(argpm)
    temp = 1.0 / (am * (1.0 - em * em))
    aynl = em * math.sin(argpm) + temp * i["aycof"]
    xl = mm + argpm + nodem + temp * i["xlcof"] * axnl

    # Kepler's equation.
    u = math.fmod(xl - nodem, _TWOPI)
    eo1 = u
    tem5 = 9999.9
    for _ in range(10):
        if abs(tem5) < 1.0e-12:
            break
        sineo1 = math.sin(eo1)
        coseo1 = math.cos(eo1)
        tem5 = 1.0 - coseo1 * axnl - sineo1 * aynl
        tem5 = (u - aynl * coseo1 + axnl * sineo1 - eo1) / tem5
        if abs(tem5) >= 0.95:
            tem5 = 0.95 if tem5 > 0 else -0.95
        eo1 += tem5
    sineo1 = math.sin(eo1)
    coseo1 = math.cos(eo1)

    # Short-period periodics.
    ecose = axnl * coseo1 + aynl * sineo1
    esine = axnl * sineo1 - aynl * coseo1
    el2 = axnl * axnl + aynl * aynl
    pl = am * (1.0 - el2)
    if pl < 0.0:
        raise err.InternalError(f"SGP4 semi-latus rectum < 0 for {s.name}")
    rl = am * (1.0 - ecose)
    betal = math.sqrt(1.0 - el2)
    temp = esine / (1.0 + betal)
    sinu = am / rl * (sineo1 - aynl - axnl * temp)
    cosu = am / rl * (coseo1 - axnl + aynl * temp)
    su = math.atan2(sinu, cosu)
    sin2u = (cosu + cosu) * sinu
    cos2u = 1.0 - 2.0 * sinu * sinu
    temp = 1.0 / pl
    temp1 = 0.5 * _J2 * temp
    temp2 = temp1 * temp
    mrt = rl * (1.0 - 1.5 * temp2 * betal * i["con41"]) + 0.5 * temp1 * i["x1mth2"] * cos2u
    su = su - 0.25 * temp2 * i["x7thm1"] * sin2u
    xnode = nodem + 1.5 * temp2 * i["cosio"] * sin2u
    xinc = s.inclo + 1.5 * temp2 * i["cosio"] * i["sinio"] * cos2u

    sinsu = math.sin(su)
    cossu = math.cos(su)
    snod = math.sin(xnode)
    cnod = math.cos(xnode)
    sini = math.sin(xinc)
    cosi = math.cos(xinc)
    ux = -snod * cosi * sinsu + cnod * cossu
    uy = cnod * cosi * sinsu + snod * cossu
    uz = sini * sinsu
    r = mrt * RADIUS_EARTH_KM
    return (r * ux, r * uy, r * uz)


# ---------------------------------------------------------------------------
# Time + frame transforms.


def gstime(jd_ut1: float) -> float:
    """Greenwich mean sidereal time (rad) from a Julian date."""
    tut1 = (jd_ut1 - 2451545.0) / 36525.0
    temp = (
        -6.2e-6 * tut1**3
        + 0.093104 * tut1**2
        + (876600.0 * 3600.0 + 8640184.812866) * tut1
        + 67310.54841
    )
    temp = math.fmod(temp * _DEG2RAD / 240.0, _TWOPI)
    if temp < 0.0:
        temp += _TWOPI
    return temp


def propagate_datetime(s: Satrec, t: datetime) -> tuple[float, float, float]:
    """TEME position (km) at datetime ``t``."""
    tsince = (_datetime_to_jd(t) - s.epoch_jd) * 1440.0
    return sgp4(s, tsince)


def eci_to_geodetic(pos_km: tuple[float, float, float], gmst: float) -> tuple[float, float, float]:
    """TEME/ECI position -> (lat rad, lon rad, alt km), WGS-72
    ellipsoid (the satellite-rs transform the reference uses)."""
    x, y, z = pos_km
    lon = math.fmod(math.atan2(y, x) - gmst, _TWOPI)
    if lon > math.pi:
        lon -= _TWOPI
    elif lon < -math.pi:
        lon += _TWOPI
    r = math.sqrt(x * x + y * y)
    e2 = _FLATTENING * (2.0 - _FLATTENING)
    lat = math.atan2(z, r)
    for _ in range(20):
        sinlat = math.sin(lat)
        c = 1.0 / math.sqrt(1.0 - e2 * sinlat * sinlat)
        new_lat = math.atan2(z + RADIUS_EARTH_KM * c * e2 * sinlat, r)
        if abs(new_lat - lat) < 1e-12:
            lat = new_lat
            break
        lat = new_lat
    sinlat = math.sin(lat)
    c = 1.0 / math.sqrt(1.0 - e2 * sinlat * sinlat)
    alt = r / math.cos(lat) - RADIUS_EARTH_KM * c
    return lat, lon, alt


def satellite_latlon(s: Satrec, t: datetime) -> tuple[float, float]:
    """(lat, lon) in radians at datetime ``t`` (the composition the
    reference uses: propagate -> gstime -> eci_to_geodedic)."""
    pos = propagate_datetime(s, t)
    gmst = gstime(_datetime_to_jd(t))
    lat, lon, _ = eci_to_geodetic(pos, gmst)
    return lat, lon


def datetime_to_jd(t: datetime) -> float:
    return _datetime_to_jd(t)
