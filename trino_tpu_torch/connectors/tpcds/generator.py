"""Vectorized, counter-based TPC-DS data generator.

Reference role: the dsdgen port behind plugin/trino-tpcds (TpcdsRecordSet).
Same design as the tpch generator: every value is a pure function of
(table, column, row index) via splitmix64 — any split generates
independently in O(rows) numpy.  Spec-shaped where queries depend on it:
surrogate-key structure (1-based, julian-day date_dim keys), FK consistency,
the sales calendar (1998-2002), the demographics cross-products, fixed
vocabularies (categories, day names, buy potentials), and sales<->returns
linkage (every return row copies its parent sale's item/ticket keys).
Value *distributions* are uniform rather than dsdgen's — documented
divergence; correctness is checked against the pandas oracle over the same
data.
"""

from __future__ import annotations

import datetime
from functools import lru_cache

import numpy as np

from trino_tpu_torch import types as T
from trino_tpu_torch.columnar.dictionary import PatternDictionary, StringDictionary
from trino_tpu_torch.connectors.api import ColumnData
from trino_tpu_torch.connectors.tpcds.schema import TABLES, column_types, scaled_rows
from trino_tpu_torch.connectors.tpch.generator import randint, _rand64

# julian day number of 1900-01-01: date_dim's first d_date_sk (spec value)
JULIAN_1900 = 2_415_022
_D1900 = datetime.date(1900, 1, 1)
_EPOCH = datetime.date(1970, 1, 1)

#: sales calendar: the window fact sold-date keys draw from (5 years)
SALES_START = JULIAN_1900 + (datetime.date(1998, 1, 2) - _D1900).days
SALES_DAYS = 365 * 5

#: inclusive randint bounds for `_generic`'s fallthrough numeric/date
#: columns.  `column_range` publishes these same tuples as EXACT range
#: claims consumed by the numeric/capacity verifiers — one definition,
#: so the generated values and the claims can never desync.
GENERIC_DECIMAL_SHORT = (0, 100_00)  # precision <= 7, scaled units
GENERIC_DECIMAL_LONG = (0, 1000_00)
GENERIC_INTEGER = (1, 100)
GENERIC_BIGINT = (1, 1000)
#: epoch-day window generic DATE columns draw from
GENERIC_DATE_BASE = (datetime.date(1998, 1, 2) - _EPOCH).days
GENERIC_DATE = (GENERIC_DATE_BASE, GENERIC_DATE_BASE + SALES_DAYS)

# -- fixed vocabularies (spec-visible values queries filter on) --------------

CATEGORIES = (
    "Books", "Children", "Electronics", "Home", "Jewelry",
    "Men", "Music", "Shoes", "Sports", "Women",
)
EDUCATION = (
    "2 yr Degree", "4 yr Degree", "Advanced Degree", "College",
    "Primary", "Secondary", "Unknown",
)
MARITAL = ("D", "M", "S", "U", "W")
CREDIT_RATING = ("Good", "High Risk", "Low Risk", "Unknown")
BUY_POTENTIAL = (">10000", "0-500", "1001-5000", "10001-20000", "501-1000", "Unknown")
DAY_NAMES = ("Sunday", "Monday", "Tuesday", "Wednesday", "Thursday", "Friday", "Saturday")
STORE_NAMES = ("able", "anti", "ation", "bar", "cally", "eing", "ese", "n st", "ought", "pri")
SIZES = ("N/A", "economy", "extra large", "large", "medium", "petite", "small")
UNITS = ("Box", "Bunch", "Bundle", "Carton", "Case", "Dozen", "Each", "Gram",
         "Gross", "Lb", "N/A", "Ounce", "Oz", "Pallet", "Pound", "Tbl", "Ton", "Unknown")
CONTAINERS = ("Unknown",)
STATES = ("AL", "AR", "AZ", "CA", "CO", "FL", "GA", "IA", "IL", "IN", "KS",
          "KY", "LA", "MI", "MN", "MO", "MS", "NC", "ND", "NE", "NY", "OH",
          "OK", "SC", "SD", "TN", "TX", "VA", "WA", "WI")
CITIES = ("Antioch", "Bethel", "Centerville", "Clifton", "Concord", "Edgewood",
          "Fairview", "Five Points", "Glendale", "Greenfield", "Greenville",
          "Jamestown", "Lakeside", "Lakeview", "Lebanon", "Liberty", "Midway",
          "Mount Olive", "Mount Zion", "Oak Grove", "Oak Hill", "Oakdale",
          "Oakland", "Pleasant Grove", "Pleasant Hill", "Riverdale",
          "Riverside", "Salem", "Shiloh", "Springdale", "Springfield",
          "Sulphur Springs", "Union", "Unionville", "Walnut Grove",
          "White Oak", "Wildwood", "Woodland", "Woodville")
COUNTIES = ("Barrow County", "Bronx County", "Daviess County", "Fairfield County",
            "Franklin Parish", "Huron County", "Luce County", "Mobile County",
            "Richland County", "Walker County", "Williamson County", "Ziebach County")
STREET_NAMES = ("1st", "2nd", "3rd", "4th", "5th", "6th", "7th", "8th", "9th",
                "10th", "Adams", "Birch", "Broadway", "Cedar", "Center", "Cherry",
                "Chestnut", "Church", "College", "Davis", "Dogwood", "East",
                "Elm", "First", "Forest", "Fourth", "Franklin", "Green", "Highland",
                "Hill", "Hillcrest", "Jackson", "Jefferson", "Johnson", "Lake",
                "Laurel", "Lee", "Lincoln", "Locust", "Madison", "Main", "Maple",
                "Meadow", "Mill", "Miller", "North", "Oak", "Park", "Pine",
                "Poplar", "Railroad", "Ridge", "River", "Second", "Sixth",
                "Smith", "South", "Spring", "Spruce", "Sunset", "Sycamore",
                "Third", "Valley", "View", "Walnut", "Washington", "West",
                "Williams", "Willow", "Wilson", "Woodland")
STREET_TYPES = ("Ave", "Avenue", "Blvd", "Boulevard", "Circle", "Court", "Ct",
                "Dr", "Drive", "Lane", "Ln", "Parkway", "Pkwy", "RD", "Rd",
                "Road", "ST", "St", "Street", "Way", "Wy")
FIRST_NAMES = ("Aaron", "Alice", "Amy", "Anna", "Anthony", "Barbara", "Betty",
               "Brian", "Carol", "Charles", "Christopher", "Daniel", "David",
               "Donald", "Donna", "Dorothy", "Edward", "Elizabeth", "Emily",
               "Eric", "George", "Helen", "James", "Jason", "Jennifer", "Jerry",
               "Jessica", "John", "Jose", "Joseph", "Karen", "Kenneth", "Kevin",
               "Kimberly", "Larry", "Laura", "Linda", "Lisa", "Margaret",
               "Maria", "Mark", "Mary", "Matthew", "Melissa", "Michael",
               "Michelle", "Nancy", "Patricia", "Paul", "Rachel", "Raymond",
               "Richard", "Robert", "Ronald", "Ruth", "Sandra", "Sarah",
               "Scott", "Sharon", "Stephen", "Steven", "Susan", "Thomas",
               "Timothy", "Virginia", "William")
LAST_NAMES = ("Adams", "Allen", "Anderson", "Bailey", "Baker", "Bell", "Brooks",
              "Brown", "Campbell", "Carter", "Clark", "Collins", "Cook",
              "Cooper", "Cox", "Davis", "Edwards", "Evans", "Foster", "Garcia",
              "Gonzalez", "Gray", "Green", "Hall", "Harris", "Henderson",
              "Hernandez", "Hill", "Howard", "Hughes", "Jackson", "James",
              "Jenkins", "Johnson", "Jones", "Kelly", "King", "Lee", "Lewis",
              "Long", "Lopez", "Martin", "Martinez", "Miller", "Mitchell",
              "Moore", "Morgan", "Morris", "Murphy", "Nelson", "Parker",
              "Perez", "Perry", "Peterson", "Phillips", "Powell", "Price",
              "Ramirez", "Reed", "Richardson", "Rivera", "Roberts", "Robinson",
              "Rodriguez", "Rogers", "Ross", "Russell", "Sanchez", "Sanders",
              "Scott", "Simmons", "Smith", "Stewart", "Taylor", "Thomas",
              "Thompson", "Torres", "Turner", "Walker", "Ward", "Washington",
              "Watson", "White", "Williams", "Wilson", "Wood", "Wright", "Young")
SALUTATIONS = ("Dr.", "Miss", "Mr.", "Mrs.", "Ms.", "Sir")
SHIFT = ("first", "second", "third")
MEAL = ("breakfast", "dinner", "lunch")
LOCATION_TYPES = ("apartment", "condo", "single family")
SHIP_TYPES = ("EXPRESS", "LIBRARY", "NEXT DAY", "OVERNIGHT", "REGULAR", "TWO DAY")
SHIP_CARRIERS = ("AIRBORNE", "ALLIANCE", "BARIAN", "BOXBUNDLES", "DHL", "DIAMOND",
                 "FEDEX", "GERMA", "GREAT EASTERN", "HARMSTORF", "LATVIAN", "MSC",
                 "ORIENTAL", "PRIVATECARRIER", "RUPEKSA", "TBS", "UPS", "USPS",
                 "ZHOU", "ZOUROS")


def _dict(values) -> StringDictionary:
    return StringDictionary(tuple(sorted(set(values))))


def _codes(d: StringDictionary, values, stream: str, idx) -> np.ndarray:
    """Random code column over an (unsorted) conceptual value list, mapped to
    the sorted dictionary's codes."""
    order = {v: i for i, v in enumerate(d.values)}
    lut = np.array([order[v] for v in values], dtype=np.int32)
    return lut[randint(stream, idx, 0, len(values) - 1)]


@lru_cache(maxsize=64)
def _pat(prefix: str, width: int, n: int) -> PatternDictionary:
    def fn(i: int) -> str:
        return f"{prefix}{i + 1:0{width}d}"

    return PatternDictionary(fn, n, (prefix, width))


# -- FK domains by column-name suffix ---------------------------------------

_FK_SUFFIX = [
    ("_item_sk", "item"),
    ("_customer_sk", "customer"),
    ("_cdemo_sk", "customer_demographics"),
    ("_hdemo_sk", "household_demographics"),
    ("_addr_sk", "customer_address"),
    ("_store_sk", "store"),
    ("_promo_sk", "promotion"),
    ("_call_center_sk", "call_center"),
    ("_catalog_page_sk", "catalog_page"),
    ("_ship_mode_sk", "ship_mode"),
    ("_warehouse_sk", "warehouse"),
    ("_web_page_sk", "web_page"),
    ("_web_site_sk", "web_site"),
    ("_reason_sk", "reason"),
    ("_income_band_sk", "income_band"),
]

_FACTS = {
    "store_sales", "store_returns", "catalog_sales", "catalog_returns",
    "web_sales", "web_returns", "inventory",
}

#: returns table -> (sales table, per-sale prefix mapping)
_RETURN_PARENT = {
    "store_returns": ("store_sales", "ss", "sr"),
    "catalog_returns": ("catalog_sales", "cs", "cr"),
    "web_returns": ("web_sales", "ws", "wr"),
}


class TpcdsGenerator:
    def __init__(self, sf: float):
        self.sf = sf

    def row_count(self, table: str) -> int:
        return scaled_rows(table, self.sf)

    # -- public: one column for a row range ----------------------------------

    def column(self, table: str, col: str, start: int, count: int) -> ColumnData:
        idx = np.arange(start, start + count, dtype=np.int64)
        t = dict(column_types(table))[col]
        special = getattr(self, f"_t_{table}", None)
        if special is not None:
            out = special(col, idx, t)
            if out is not None:
                return out
        return self._generic(table, col, idx, t)

    def dictionary(self, table: str, col: str):
        """Global dictionary for a string column (trace-stable across splits)."""
        cd = self.column(table, col, 0, 1)
        return cd.dictionary

    def column_range(self, table: str, col: str):
        """Exact (low, high) LOGICAL-unit value range of a GENERICALLY
        generated column, or None when no sound claim exists.  Mirrors
        `column()`'s dispatch: a column a `_t_<table>` special handles
        makes no generic claim (probed with one row — cheap, and exact
        because the dispatch is per-column, not per-row).  These ranges
        are the generator's own rules (randint bounds are inclusive), so
        they are admissible proof sources for the numeric/capacity
        verifiers — the same standing as the key-range stats above."""
        t = dict(column_types(table))[col]
        special = getattr(self, f"_t_{table}", None)
        if special is not None:
            try:
                if special(col, np.arange(1, dtype=np.int64), t) is not None:
                    return None
            except Exception:
                return None
        if col.endswith(("_sk", "_id")):
            return None  # key columns: explicit stats rules in the connector
        for suffix, _ref in _FK_SUFFIX:
            if col.endswith(suffix):
                return None
        if isinstance(t, T.DecimalType):
            lo, hi = (
                GENERIC_DECIMAL_SHORT if t.precision <= 7
                else GENERIC_DECIMAL_LONG
            )
            return (lo, hi / t.scale_factor)
        if t.name == "integer":
            return GENERIC_INTEGER
        if t.name == "bigint":
            return GENERIC_BIGINT
        if t is T.DATE:
            return GENERIC_DATE
        return None

    # -- generic rules --------------------------------------------------------

    def _generic(self, table: str, col: str, idx, t) -> ColumnData:
        stream = f"{table}.{col}"
        n = self.row_count(table)
        # primary surrogate key: 1-based row number
        if col.endswith("_sk") and self._is_primary_key(table, col):
            return ColumnData(idx + 1, None)
        if col.endswith("_date_sk"):
            return self._date_fk(table, stream, idx)
        if col.endswith("_time_sk"):
            vals = randint(stream, idx, 0, 86_399)
            return self._nullable(stream, vals, table, idx)
        for suffix, ref in _FK_SUFFIX:
            if col.endswith(suffix):
                vals = randint(stream, idx, 1, self.row_count(ref))
                return self._nullable(stream, vals, table, idx)
        if col.endswith("_id") and T.is_string_kind(t):
            # business identifiers are strings (e.g. i_item_id); integer
            # *_id columns (s_market_id, s_division_id) fall through to the
            # numeric branches below
            prefix = col[: col.index("_")].upper() + "-"
            d = _pat(prefix, 12, max(n, 1))
            return ColumnData(idx.astype(np.int32), None, d)
        if isinstance(t, T.DecimalType):
            lo, hi = (
                GENERIC_DECIMAL_SHORT if t.precision <= 7
                else GENERIC_DECIMAL_LONG
            )
            return ColumnData(randint(stream, idx, lo, hi), None)
        if t.name == "integer":
            return ColumnData(
                randint(stream, idx, *GENERIC_INTEGER).astype(np.int32), None
            )
        if t.name == "bigint":
            return ColumnData(randint(stream, idx, *GENERIC_BIGINT), None)
        if t is T.DATE:
            return ColumnData(
                randint(
                    stream, idx, GENERIC_DATE[0], GENERIC_DATE[1]
                ).astype(np.int32),
                None,
            )
        if T.is_string_kind(t):
            if col.endswith(("_flag", "_active")) or t.name == "varchar(1)":
                d = _dict(["N", "Y"])
                return ColumnData(_codes(d, ["N", "Y", "N", "N"], stream, idx), None, d)
            d = _dict([f"{col.split('_')[-1]}{i}" for i in range(16)])
            return ColumnData(
                randint(stream, idx, 0, len(d.values) - 1).astype(np.int32), None, d
            )
        raise NotImplementedError(f"tpcds generic column {table}.{col}: {t.name}")

    def _is_primary_key(self, table: str, col: str) -> bool:
        # dimension tables lead with their surrogate key; fact tables have no
        # surrogate PK (their leading *_sk columns are FKs, e.g.
        # ss_sold_date_sk)
        return table not in _FACTS and TABLES[table][0][0] == col

    def _nullable(self, stream: str, vals, table: str, idx, pct: int = 25):
        """Fact-table FKs are ~4% NULL (spec allows nulls in fact FKs).
        The null stream MUST be driven by the global row index `idx`, never a
        slice-local arange — generated data has to be identical under any
        split slicing (round-3 fix: multi-split scans produced different
        masks than single-split scans)."""
        if table not in _FACTS:
            return ColumnData(vals, None)
        valid = randint(stream + ".null", idx + vals, 0, pct) != 0
        return ColumnData(vals, valid)

    def _date_fk(self, table: str, stream: str, idx) -> ColumnData:
        vals = SALES_START + randint(stream, idx, 0, SALES_DAYS - 1)
        return self._nullable(stream, vals, table, idx)

    # -- calendar dimensions --------------------------------------------------

    def _t_date_dim(self, col, idx, t):
        dates = np.datetime64("1900-01-01") + idx.astype("timedelta64[D]")
        # datetime64 integer epochs are 1970-based
        years = dates.astype("datetime64[Y]").astype(np.int64) + 1970
        months0 = dates.astype("datetime64[M]").astype(np.int64) + 70 * 12  # since 1900-01
        moy = months0 % 12 + 1
        dom = (dates - dates.astype("datetime64[M]")).astype(np.int64) + 1
        dow = (idx + 1) % 7  # 1900-01-01 was a Monday; 0=Sunday
        if col == "d_date_sk":
            return ColumnData(idx + JULIAN_1900, None)
        if col == "d_date":
            days70 = (_D1900 - _EPOCH).days
            return ColumnData((idx + days70).astype(np.int32), None)
        if col == "d_year" or col == "d_fy_year":
            return ColumnData(years.astype(np.int32), None)
        if col == "d_moy":
            return ColumnData(moy.astype(np.int32), None)
        if col == "d_dom":
            return ColumnData(dom.astype(np.int32), None)
        if col == "d_dow":
            return ColumnData(dow.astype(np.int32), None)
        if col == "d_month_seq":
            return ColumnData(months0.astype(np.int32), None)
        if col in ("d_week_seq", "d_fy_week_seq"):
            return ColumnData(((idx + 1) // 7 + 1).astype(np.int32), None)
        if col in ("d_quarter_seq", "d_fy_quarter_seq"):
            return ColumnData((months0 // 3 + 1).astype(np.int32), None)
        if col == "d_qoy":
            return ColumnData(((moy - 1) // 3 + 1).astype(np.int32), None)
        if col == "d_day_name":
            d = _dict(DAY_NAMES)
            order = np.array([d.index[v] for v in DAY_NAMES], np.int32)
            return ColumnData(order[dow], None, d)
        if col == "d_quarter_name":
            names = [f"{y}Q{q}" for y in range(1900, 2101) for q in range(1, 5)]
            d = _dict(names)
            qidx = (years - 1900) * 4 + (moy - 1) // 3
            order = np.array([d.index[v] for v in names], np.int32)
            return ColumnData(order[qidx], None, d)
        if col in ("d_holiday", "d_following_holiday", "d_current_day",
                   "d_current_week", "d_current_month", "d_current_quarter",
                   "d_current_year"):
            d = _dict(["N", "Y"])
            return ColumnData(np.full(len(idx), d.index["N"], np.int32), None, d)
        if col == "d_weekend":
            d = _dict(["N", "Y"])
            wk = np.where((dow == 0) | (dow == 6), d.index["Y"], d.index["N"])
            return ColumnData(wk.astype(np.int32), None, d)
        if col == "d_first_dom":
            first = dates.astype("datetime64[M]").astype("datetime64[D]")
            return ColumnData(
                (first - np.datetime64("1900-01-01")).astype(np.int64) + JULIAN_1900,
                None,
            )
        if col == "d_last_dom":
            nxt = (dates.astype("datetime64[M]") + 1).astype("datetime64[D]")
            return ColumnData(
                (nxt - np.datetime64("1900-01-01")).astype(np.int64) + JULIAN_1900 - 1,
                None,
            )
        if col == "d_same_day_ly":
            return ColumnData(idx + JULIAN_1900 - 365, None)
        if col == "d_same_day_lq":
            return ColumnData(idx + JULIAN_1900 - 91, None)
        if col == "d_date_id":
            d = _pat("D-", 12, self.row_count("date_dim"))
            return ColumnData(idx.astype(np.int32), None, d)
        return None

    def _t_time_dim(self, col, idx, t):
        if col == "t_time_sk" or col == "t_time":
            return ColumnData(idx if col == "t_time_sk" else idx.astype(np.int32), None)
        if col == "t_hour":
            return ColumnData((idx // 3600).astype(np.int32), None)
        if col == "t_minute":
            return ColumnData((idx // 60 % 60).astype(np.int32), None)
        if col == "t_second":
            return ColumnData((idx % 60).astype(np.int32), None)
        if col == "t_am_pm":
            d = _dict(["AM", "PM"])
            return ColumnData(
                np.where(idx < 43200, d.index["AM"], d.index["PM"]).astype(np.int32),
                None, d,
            )
        if col == "t_shift":
            d = _dict(SHIFT)
            order = np.array([d.index[v] for v in SHIFT], np.int32)
            return ColumnData(order[(idx // 28800).astype(np.int64) % 3], None, d)
        if col == "t_sub_shift":
            d = _dict(SHIFT)
            order = np.array([d.index[v] for v in SHIFT], np.int32)
            return ColumnData(order[(idx // 9600).astype(np.int64) % 3], None, d)
        if col == "t_meal_time":
            d = _dict(MEAL)
            code = np.where(
                (idx >= 6 * 3600) & (idx < 9 * 3600), d.index["breakfast"],
                np.where(
                    (idx >= 12 * 3600) & (idx < 14 * 3600), d.index["lunch"],
                    np.where((idx >= 18 * 3600) & (idx < 20 * 3600),
                             d.index["dinner"], -1),
                ),
            )
            valid = code >= 0
            return ColumnData(np.maximum(code, 0).astype(np.int32), valid, d)
        return None

    # -- demographics cross-products -----------------------------------------

    def _t_customer_demographics(self, col, idx, t):
        # mixed radix over (gender 2, marital 5, education 7, purchase 20,
        # credit 4, dep 7, dep_emp 7, dep_college 7) = 1,920,800 rows
        i = idx.copy()
        gender = i % 2; i //= 2
        marital = i % 5; i //= 5
        edu = i % 7; i //= 7
        purch = i % 20; i //= 20
        credit = i % 4; i //= 4
        dep = i % 7; i //= 7
        dep_emp = i % 7; i //= 7
        dep_col = i % 7
        if col == "cd_demo_sk":
            return ColumnData(idx + 1, None)
        if col == "cd_gender":
            d = _dict(["F", "M"])
            return ColumnData(gender.astype(np.int32), None, d)
        if col == "cd_marital_status":
            d = _dict(MARITAL)
            return ColumnData(marital.astype(np.int32), None, d)
        if col == "cd_education_status":
            d = _dict(EDUCATION)
            return ColumnData(edu.astype(np.int32), None, d)
        if col == "cd_purchase_estimate":
            return ColumnData(((purch + 1) * 500).astype(np.int32), None)
        if col == "cd_credit_rating":
            d = _dict(CREDIT_RATING)
            return ColumnData(credit.astype(np.int32), None, d)
        if col == "cd_dep_count":
            return ColumnData(dep.astype(np.int32), None)
        if col == "cd_dep_employed_count":
            return ColumnData(dep_emp.astype(np.int32), None)
        if col == "cd_dep_college_count":
            return ColumnData(dep_col.astype(np.int32), None)
        return None

    def _t_household_demographics(self, col, idx, t):
        i = idx.copy()
        band = i % 20; i //= 20
        buy = i % 6; i //= 6
        dep = i % 10; i //= 10
        veh = i % 6
        if col == "hd_demo_sk":
            return ColumnData(idx + 1, None)
        if col == "hd_income_band_sk":
            return ColumnData(band + 1, None)
        if col == "hd_buy_potential":
            d = _dict(BUY_POTENTIAL)
            order = np.array([d.index[v] for v in BUY_POTENTIAL], np.int32)
            return ColumnData(order[buy], None, d)
        if col == "hd_dep_count":
            return ColumnData(dep.astype(np.int32), None)
        if col == "hd_vehicle_count":
            return ColumnData((veh - 1).astype(np.int32), None)
        return None

    def _t_income_band(self, col, idx, t):
        if col == "ib_income_band_sk":
            return ColumnData(idx + 1, None)
        if col == "ib_lower_bound":
            return ColumnData((idx * 10_000 + 1).astype(np.int32), None)
        if col == "ib_upper_bound":
            return ColumnData(((idx + 1) * 10_000).astype(np.int32), None)
        return None

    # -- item / stores / addresses -------------------------------------------

    def _t_item(self, col, idx, t):
        stream = f"item.{col}"
        if col == "i_category":
            d = _dict(CATEGORIES)
            order = np.array([d.index[v] for v in CATEGORIES], np.int32)
            return ColumnData(order[self._item_category(idx)], None, d)
        if col == "i_category_id":
            return ColumnData((self._item_category(idx) + 1).astype(np.int32), None)
        if col == "i_brand_id":
            return ColumnData(self._item_brand_id(idx).astype(np.int32), None)
        if col == "i_brand":
            n = 5004
            d = _pat("Brand#", 8, n)
            return ColumnData(self._item_brand_id(idx).astype(np.int32) % n, None, d)
        if col == "i_class_id":
            return ColumnData((randint(stream, idx, 1, 16)).astype(np.int32), None)
        if col == "i_class":
            d = _dict([f"class{i:02d}" for i in range(1, 17)])
            return ColumnData(
                randint(stream, idx, 0, 15).astype(np.int32), None, d
            )
        if col == "i_manufact_id":
            return ColumnData(randint(stream, idx, 1, 1000).astype(np.int32), None)
        if col == "i_manufact":
            d = _pat("Manufact#", 8, 1000)
            return ColumnData(
                randint(stream, idx, 0, 999).astype(np.int32), None, d
            )
        if col == "i_size":
            d = _dict(SIZES)
            return ColumnData(randint(stream, idx, 0, len(SIZES) - 1).astype(np.int32), None, d)
        if col == "i_units":
            d = _dict(UNITS)
            return ColumnData(randint(stream, idx, 0, len(UNITS) - 1).astype(np.int32), None, d)
        if col == "i_color":
            from trino_tpu_torch.connectors.tpch.generator import COLORS

            d = _dict(COLORS)
            return ColumnData(randint(stream, idx, 0, len(COLORS) - 1).astype(np.int32), None, d)
        if col == "i_product_name":
            d = _pat("Product#", 10, self.row_count("item"))
            return ColumnData(idx.astype(np.int32), None, d)
        if col == "i_item_desc":
            d = _pat("item description ", 10, 1000)
            return ColumnData(randint(stream, idx, 0, 999).astype(np.int32), None, d)
        if col == "i_manager_id":
            return ColumnData(randint(stream, idx, 1, 100).astype(np.int32), None)
        if col == "i_current_price":
            return ColumnData(randint(stream, idx, 99, 99_99), None)
        if col == "i_wholesale_cost":
            return ColumnData(randint(stream, idx, 50, 70_00), None)
        if col in ("i_rec_start_date", "i_rec_end_date"):
            base = (datetime.date(1997, 10, 27) - _EPOCH).days
            return ColumnData(np.full(len(idx), base, np.int32), None)
        return None

    def _item_category(self, idx) -> np.ndarray:
        return randint("item.category", idx, 0, len(CATEGORIES) - 1)

    def _item_brand_id(self, idx) -> np.ndarray:
        # brand id encodes the category like dsdgen's NMMM... shape
        cat = self._item_category(idx) + 1
        m = randint("item.brandm", idx, 1, 1000)
        return cat * 1_000_000 + m

    def _t_store(self, col, idx, t):
        if col == "s_store_name":
            d = _dict(STORE_NAMES)
            order = np.array([d.index[v] for v in STORE_NAMES], np.int32)
            return ColumnData(order[idx % len(STORE_NAMES)], None, d)
        if col == "s_state":
            d = _dict(STATES[:9])
            return ColumnData(
                randint("store.state", idx, 0, 8).astype(np.int32), None, d
            )
        if col in ("s_city",):
            d = _dict(CITIES[:12])
            return ColumnData(randint("store.city", idx, 0, 11).astype(np.int32), None, d)
        if col == "s_county":
            d = _dict(COUNTIES)
            return ColumnData(randint("store.county", idx, 0, len(COUNTIES) - 1).astype(np.int32), None, d)
        if col == "s_zip":
            d = _pat("", 5, 99999)
            return ColumnData(randint("store.zip", idx, 0, 9999).astype(np.int32), None, d)
        if col == "s_gmt_offset":
            return ColumnData(np.full(len(idx), -500, np.int64), None)
        if col == "s_number_employees":
            return ColumnData(randint("store.emp", idx, 200, 300).astype(np.int32), None)
        if col == "s_floor_space":
            return ColumnData(randint("store.fs", idx, 5_000_000, 10_000_000).astype(np.int32), None)
        if col in ("s_rec_start_date", "s_rec_end_date"):
            base = (datetime.date(1997, 3, 13) - _EPOCH).days
            return ColumnData(np.full(len(idx), base, np.int32), None)
        return None

    def _t_customer_address(self, col, idx, t):
        stream = f"customer_address.{col}"
        if col == "ca_state":
            d = _dict(STATES)
            return ColumnData(randint(stream, idx, 0, len(STATES) - 1).astype(np.int32), None, d)
        if col == "ca_city":
            d = _dict(CITIES)
            return ColumnData(randint(stream, idx, 0, len(CITIES) - 1).astype(np.int32), None, d)
        if col == "ca_county":
            d = _dict(COUNTIES)
            return ColumnData(randint(stream, idx, 0, len(COUNTIES) - 1).astype(np.int32), None, d)
        if col == "ca_zip":
            d = _pat("", 5, 99999)
            return ColumnData(randint(stream, idx, 0, 99_998).astype(np.int32), None, d)
        if col == "ca_street_name":
            d = _dict(STREET_NAMES)
            return ColumnData(randint(stream, idx, 0, len(STREET_NAMES) - 1).astype(np.int32), None, d)
        if col == "ca_street_type":
            d = _dict(STREET_TYPES)
            return ColumnData(randint(stream, idx, 0, len(STREET_TYPES) - 1).astype(np.int32), None, d)
        if col == "ca_street_number":
            d = _pat("", 4, 9999)
            return ColumnData(randint(stream, idx, 0, 9998).astype(np.int32), None, d)
        if col == "ca_suite_number":
            d = _pat("Suite ", 3, 100)
            return ColumnData(randint(stream, idx, 0, 99).astype(np.int32), None, d)
        if col == "ca_country":
            d = _dict(["United States"])
            return ColumnData(np.zeros(len(idx), np.int32), None, d)
        if col == "ca_gmt_offset":
            return ColumnData(-randint(stream, idx, 500, 800), None)
        if col == "ca_location_type":
            d = _dict(LOCATION_TYPES)
            return ColumnData(randint(stream, idx, 0, 2).astype(np.int32), None, d)
        return None

    def _t_customer(self, col, idx, t):
        stream = f"customer.{col}"
        if col == "c_first_name":
            d = _dict(FIRST_NAMES)
            return ColumnData(randint(stream, idx, 0, len(FIRST_NAMES) - 1).astype(np.int32), None, d)
        if col == "c_last_name":
            d = _dict(LAST_NAMES)
            return ColumnData(randint(stream, idx, 0, len(LAST_NAMES) - 1).astype(np.int32), None, d)
        if col == "c_salutation":
            d = _dict(SALUTATIONS)
            return ColumnData(randint(stream, idx, 0, len(SALUTATIONS) - 1).astype(np.int32), None, d)
        if col == "c_preferred_cust_flag":
            d = _dict(["N", "Y"])
            return ColumnData(randint(stream, idx, 0, 1).astype(np.int32), None, d)
        if col == "c_birth_day":
            return ColumnData(randint(stream, idx, 1, 28).astype(np.int32), None)
        if col == "c_birth_month":
            return ColumnData(randint(stream, idx, 1, 12).astype(np.int32), None)
        if col == "c_birth_year":
            return ColumnData(randint(stream, idx, 1924, 1992).astype(np.int32), None)
        if col == "c_birth_country":
            from trino_tpu_torch.connectors.tpch.generator import NATIONS

            names = [n for n, _ in NATIONS]
            d = _dict(names)
            return ColumnData(randint(stream, idx, 0, len(names) - 1).astype(np.int32), None, d)
        if col == "c_login":
            d = _pat("login", 8, 100_000)
            return ColumnData((idx % 100_000).astype(np.int32), None, d)
        if col == "c_email_address":
            d = _pat("customer", 10, self.row_count("customer"))
            return ColumnData(idx.astype(np.int32), None, d)
        if col in ("c_first_shipto_date_sk", "c_first_sales_date_sk",
                   "c_last_review_date_sk"):
            return ColumnData(
                SALES_START + randint(stream, idx, 0, SALES_DAYS - 1), None
            )
        return None

    def _t_ship_mode(self, col, idx, t):
        if col == "sm_type":
            d = _dict(SHIP_TYPES)
            order = np.array([d.index[v] for v in SHIP_TYPES], np.int32)
            return ColumnData(order[idx % len(SHIP_TYPES)], None, d)
        if col == "sm_carrier":
            d = _dict(SHIP_CARRIERS)
            order = np.array([d.index[v] for v in SHIP_CARRIERS], np.int32)
            return ColumnData(order[idx % len(SHIP_CARRIERS)], None, d)
        return None

    # -- fact tables ----------------------------------------------------------

    def _t_store_sales(self, col, idx, t):
        if col == "ss_ticket_number":
            return ColumnData(idx // 12 + 1, None)
        return None

    def _t_catalog_sales(self, col, idx, t):
        if col == "cs_order_number":
            return ColumnData(idx // 14 + 1, None)
        return None

    def _t_web_sales(self, col, idx, t):
        if col == "ws_order_number":
            return ColumnData(idx // 14 + 1, None)
        return None

    def _t_inventory(self, col, idx, t):
        if col == "inv_date_sk":
            # weekly snapshots over the calendar
            week = idx // (self.row_count("item") * self.row_count("warehouse"))
            return ColumnData(SALES_START + week * 7, None)
        if col == "inv_item_sk":
            return ColumnData(idx % self.row_count("item") + 1, None)
        if col == "inv_warehouse_sk":
            return ColumnData(
                (idx // self.row_count("item")) % self.row_count("warehouse") + 1,
                None,
            )
        return None

    def _t_store_returns(self, col, idx, t):
        return self._return_column("store_returns", col, idx)

    def _t_catalog_returns(self, col, idx, t):
        return self._return_column("catalog_returns", col, idx)

    def _t_web_returns(self, col, idx, t):
        return self._return_column("web_returns", col, idx)

    def _return_column(self, table, col, idx):
        """Return rows copy the linking keys of a deterministic parent sale
        row, so sales<->returns joins behave like the reference's."""
        sales_table, sp, rp = _RETURN_PARENT[table]
        parent = _rand64(f"{table}.parent", idx) % np.uint64(
            max(1, self.row_count(sales_table))
        )
        parent = parent.astype(np.int64)

        def parent_col(name: str):
            # parent indexes are scattered; generate per-value via the pure
            # column functions (vectorized over the parent index array)
            t2 = dict(column_types(sales_table))[name]
            special = getattr(self, f"_t_{sales_table}", None)
            out = special(name, parent, t2) if special is not None else None
            if out is None:
                out = self._generic(sales_table, name, parent, t2)
            return out

        link = {
            f"{rp}_item_sk": f"{sp}_item_sk",
            f"{rp}_ticket_number": f"{sp}_ticket_number",
            f"{rp}_order_number": f"{sp}_order_number",
            f"{rp}_customer_sk": f"{sp}_customer_sk",
            f"{rp}_returning_customer_sk": (
                f"{sp}_bill_customer_sk" if sp != "ss" else None
            ),
            f"{rp}_refunded_customer_sk": (
                f"{sp}_bill_customer_sk" if sp != "ss" else None
            ),
        }
        src = link.get(col)
        if src:
            return parent_col(src)
        if col == f"{rp}_returned_date_sk":
            sold = parent_col(f"{sp}_sold_date_sk")
            lag = randint(f"{table}.lag", idx, 1, 90)
            vals = np.asarray(sold.values) + lag
            return ColumnData(vals, sold.valid)
        return None


@lru_cache(maxsize=8)
def generator(sf: float) -> TpcdsGenerator:
    return TpcdsGenerator(sf)
